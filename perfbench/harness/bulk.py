"""Bulk captioning: a closed loop of ``Captioner.caption_images`` calls, each
over the same seeded set of uint8 images (``images_per_call`` of
``image_px`` square), in the mix's decode mode.

The window runs from the first call's start to the end of the last call
started within ``--seconds``; ``serve_img_s`` is every image captioned in
it over its length. Afterwards a sample of the served captions, drawn from
the seed and holding the longest, is held against the reference
(``harness.served``).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from harness import cell as cell_lib, instrument, plugins, served, traffic
from harness.trace import Run, profile_window


class Driver:
    def __init__(self, cell: cell_lib.Cell, seed: int, device, run: Run):
        self.cell, self.seed, self.device, self.run = cell, seed, device, run
        self.mode = cell.mix_value("mode")
        self.served: List[List[str]] = []
        self.recorder = served.BeamRecorder()
        self.call_parts: List = []  # each call's span of the recorder's searches

    def setup(self) -> None:
        from show_and_tell_tpu_torch.serve import Captioner

        cfg = self.cfg = self.cell.port_config()
        self.arch = self.cell.arch
        self.wraps = plugins.of(cfg)[0].WRAPS
        self.model, self.weights = cell_lib.build_model(self.cell, self.seed, self.device)
        self.cap = Captioner(cfg, self.model, None, self.cell.vocabulary(), device=self.device)
        n, px = self.cell.mix_value("images_per_call"), self.cell.mix_value("image_px")
        self.images = traffic.images(n, px, px, self.seed, self.device).cpu().numpy()
        # the shapes this traffic runs: its chunks' buckets, each once
        buckets = sorted({chunk.shape[0] for _, chunk, _ in self.cap._chunks(self.images)})
        self.cap.warmup(modes=(self.mode,), buckets=buckets)
        for b in buckets:
            self.cap.caption_images(self.images[:b], mode=self.mode)
        self._sync()

    def _sync(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def _call(self) -> None:
        start = len(self.recorder.searches)
        with self.recorder.recording():
            self.served.append(self.cap.caption_images(self.images, mode=self.mode))
        self.call_parts.append((start, len(self.recorder.searches)))

    def window(self, seconds: float) -> Dict[str, float]:
        t0 = time.perf_counter()
        self._call()
        while time.perf_counter() - t0 < seconds:
            self._call()
        wall = time.perf_counter() - t0
        return {"serve_img_s": len(self.served) * self.images.shape[0] / wall}

    def traced(self) -> None:
        """The traced calls three times: counted but neither synchronised
        nor profiled (the wall time that ``mfu.serve`` divides by, and the
        trunk's CUDA events); with the decode timed to a synchronise
        (``decode_ms``); and under the profiler (the device timeline and the
        kernels' calls)."""
        run, n, wraps = self.run, self.cell.mix_value("traced_calls"), self.wraps
        with instrument.serving(run, wraps, decode_timer=False):
            t0 = time.perf_counter()
            for _ in range(n):
                self._call()
            run.unprofiled_s = time.perf_counter() - t0
        run.settle()
        flops = plugins.model_flops(self.cfg, self.cell.vocab_size, run.counters, self.arch)
        with instrument.serving(run, wraps):
            for _ in range(n):
                self._call()
        run.settle()
        timers = dict(run.timers)
        # the profiled calls' own counts, for the rooflines
        run.counters = type(run.counters)(float, model_flops=flops)
        with instrument.serving(run, wraps, decode_timer=False):
            run.profile = profile_window(lambda: [self._call() for _ in range(n)])
        run.settle()
        run.timers.clear()
        run.timers.update(timers)

    @property
    def attempted(self) -> int:
        return sum(len(c) for c in self.served)

    def release(self) -> None:
        del self.cap, self.model

    def _sample(self):
        """The sampled served captions, their images and the records of the
        searches that served them (a call's chunks run in order; the last
        is padded to its bucket at its end)."""
        n = self.images.shape[0]
        flat = [c for call in self.served for c in call]
        words = np.array([len(c.split()) for c in flat])
        longest = np.flatnonzero(words == words.max())[:2]
        rows = cell_lib.sample_rows(len(flat), self.cell.mix_value("check_sample"), self.seed, longest)
        images = torch.from_numpy(self.images[rows % n]).to(self.device)
        records = [self.recorder.in_order(*self.call_parts[r // n], r % n) for r in rows]
        return [flat[r] for r in rows], images, records

    def check(self) -> Dict[str, float]:
        captions, images, records = self._sample()
        return served.judge(self.cfg, self.arch, self.weights, images, captions, records)

    def control(self, q) -> Dict[str, float]:
        return served.control(self.cfg, self.arch, self.weights, self._sample()[1], q)

    def altered(self) -> Dict[str, float]:
        captions, images, records = self._sample()
        return served.judge(self.cfg, self.arch, self.weights, images,
                            served.altered(captions, self.cell.vocab_size), records)
