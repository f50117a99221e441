"""Training: back-to-back ``TrainStep`` calls at the configuration's batch
size on uint8 images, with the random crop and flip on the device.

A pool of seeded 256-px images sits in pinned host memory in batch order;
each step's batch is copied to the card one step ahead, as the trainer's
``_to_device`` does. Captions have seeded lengths (``harness.traffic``) and
are padded to the length buckets that ``data/dataset.py`` forms (quartiles
of the encoded lengths, rounded up to multiples of 4, at most
``max_caption_len``); the window runs through the pool's batches in a seeded
order. ``train_img_s`` is the images of every step in the window over its
length, to a synchronise.

Set-up drives the one step object from the benchmark's weights through its
first steps, on the window's own call and feed and on batches whose rows
all differ, and keeps what the reference checks: each step's loss, the first
gradient as Adam got it (from its first moment after one step) and the
parameters after ``check_steps`` steps. The window continues from there.
"""

from __future__ import annotations

import statistics
import sys
import time
from typing import Dict

import numpy as np
import torch

from harness import cell as cell_lib, plugins, traffic
from harness.trace import Run, profile_window, span
from reference import train as ref_train

BUCKET_MULTIPLE = 4


def bucket_edges(enc_lens: np.ndarray, buckets: int, max_len: int):
    """``data/dataset.py``'s padded lengths for these encoded lengths."""
    def up(x):
        return int(-(-int(np.ceil(x)) // BUCKET_MULTIPLE) * BUCKET_MULTIPLE)

    qs = np.quantile(enc_lens, np.linspace(0, 1, buckets + 1)[1:])
    edges = sorted({up(q) for q in qs})
    edges[-1] = up(enc_lens.max())
    return [min(e, max_len) for e in edges]


class Driver:
    def __init__(self, cell: cell_lib.Cell, seed: int, device, run: Run):
        self.cell, self.seed, self.device, self.run = cell, seed, device, run
        self.steps = 0
        self.failed = 0

    # --- traffic -----------------------------------------------------------

    def _batches(self, cfg):
        mix = self.cell.mix_value
        B, n = cfg.batch_size, mix("pool_images")
        lengths = traffic.caption_lengths(n, mix("log_words_mu"), mix("log_words_sigma"), mix("min_words"),
                                          mix("max_words"), self.seed)
        caps, enc = traffic.captions(lengths, self.cell.vocab_size, self.seed)
        enc = np.minimum(enc, cfg.max_caption_len)
        edges = bucket_edges(enc, mix("length_buckets"), cfg.max_caption_len)
        plan = []
        assigned = np.zeros(n, bool)
        for edge in edges:
            idx = np.flatnonzero((enc <= edge) & ~assigned)
            assigned[idx] = True
            for i in range(0, len(idx), B):
                chunk = idx[i : i + B]
                if len(chunk) < B:  # repeat the last, as the dataset pads a short batch
                    chunk = np.concatenate([chunk, np.full(B - len(chunk), chunk[-1])])
                plan.append((chunk, edge))
        return caps, enc, plan

    def setup(self) -> None:
        from show_and_tell_tpu_torch.train.step import make_train_state, make_train_step

        cfg = self.cfg = self.cell.port_config()
        mix = self.cell.mix_value
        self.arch = self.cell.arch
        net, trunk = plugins.of(cfg)
        self.train_step_flops = net.train_step_flops
        self.trunk_flops = trunk.flops(cfg)
        self.model, self.weights = cell_lib.build_model(self.cell, self.seed, self.device)
        self.state = make_train_state(cfg, self.model)
        self.step = make_train_step(self.model, cfg)
        caps, enc, plan = self._batches(cfg)
        px = mix("image_px")
        pool = traffic.images(mix("pool_images"), px, px, self.seed, self.device)
        pin = torch.device(self.device).type == "cuda"
        self.host = []
        for idx, pad in plan:
            images = pool[torch.as_tensor(idx, device=pool.device)].cpu()
            c = torch.from_numpy(caps[idx, :pad].copy())
            ln = torch.from_numpy(np.minimum(enc[idx], pad))
            self.host.append({k: (v.pin_memory() if pin else v) for k, v in
                              {"images": images, "captions": c, "lengths": ln}.items()})
        del pool
        rng = np.random.default_rng(traffic.substream(self.seed, traffic.CAPTIONS) ^ 2)
        self.order = [int(i) for i in rng.permutation(len(self.host))]
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(traffic.substream(self.seed, traffic.CROPS))
        self.lr = cfg.learning_rate
        self._next = self._copy(self.order[0])
        self.cursor = 0
        # the checked steps: the window's own call and feed on distinct rows
        n_check = mix("check_steps")
        self.check_batches = [self.order[i] for i in range(n_check)]
        self.losses = []
        for i in range(n_check):
            m = self._step()
            self.losses.append(float(m["loss"]))
            if i == 0:
                self.first_grad = {k: v.detach().clone() / (1 - 0.9) for k, v in self.state.opt_state["mu"].items()}
        self.after = {k: v.detach().clone() for k, v in self.state.params.items()}
        # every padded length the window will see, once more
        seen = {int(self.host[j]["captions"].shape[1]) for j in self.check_batches}
        for j in self.order:
            T = int(self.host[j]["captions"].shape[1])
            if T not in seen:
                seen.add(T)
                self._step()
        self._sync()

    def _sync(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def _copy(self, j: int):
        return {k: v.to(self.device, non_blocking=True) for k, v in self.host[j].items()}

    def _step(self):
        """One step on the next batch of the order, the one after it already
        on its way."""
        batch = self._next
        self.cursor += 1
        self._next = self._copy(self.order[self.cursor % len(self.order)])
        self.state, metrics = self.step(self.state, batch, self.lr, generator=self.gen)
        self.steps += 1
        self.last_T = int(batch["captions"].shape[1])
        return metrics

    # --- windows -----------------------------------------------------------

    def window(self, seconds: float) -> Dict[str, float]:
        B = self.cfg.batch_size
        self.steps = 0
        t0 = time.perf_counter()
        self._step()
        while time.perf_counter() - t0 < seconds:
            self._step()
        self._sync()
        wall = time.perf_counter() - t0
        return {"train_img_s": self.steps * B / wall}

    def traced(self) -> None:
        """The traced steps twice: first timed by CUDA events but not
        profiled (the phases' times, and the wall time that ``mfu.train``
        divides by), then under the profiler (the device timeline)."""
        run, step, cfg = self.run, self.step, self.cfg
        V, B, n = self.cell.vocab_size, cfg.batch_size, self.cell.mix_value("traced_steps")
        features, backward = step.features, step.backward

        def timed_features(*a, **kw):
            with span("trunk"), run.device_timer("trunk_ms"):
                return features(*a, **kw)

        def timed_backward(*a, **kw):
            with span("backward"), run.device_timer("backward_ms"):
                return backward(*a, **kw)

        def steps():
            flops = 0.0
            for _ in range(n):
                with span("step"):
                    self._step()
                flops += self.train_step_flops(cfg, V, B, self.last_T, self.trunk_flops, self.arch)
            return flops

        step.features, step.backward = timed_features, timed_backward
        try:
            self._sync()
            t0 = time.perf_counter()
            run.counters["model_flops"] = steps()
            self._sync()
            run.unprofiled_s = time.perf_counter() - t0
            run.settle()
            timers = dict(run.timers)
            run.profile = profile_window(steps)
            run.settle()
            run.timers.clear()
            run.timers.update(timers)
        finally:
            del step.features, step.backward

    @property
    def attempted(self) -> int:
        return self.steps

    def release(self) -> None:
        del self.step, self.state, self.model

    # --- the check -----------------------------------------------------------

    def _reference(self, q=None):
        cfg, arch = self.cfg, self.arch
        g = torch.Generator(device=self.device)
        g.manual_seed(traffic.substream(self.seed, traffic.CROPS))
        batches = [tuple(self.host[j][k].to(self.device) for k in ("images", "captions", "lengths"))
                   for j in self.check_batches]
        with cell_lib.full_fp32():
            return ref_train.train(lambda w, q: plugins.reference(cfg, w, arch, q), self.weights, batches, g,
                                   cfg.crop_size, cfg.learning_rate, cfg.grad_clip, q=q)

    def _compare(self, losses, first, after, ref) -> Dict[str, float]:
        """Each step's loss, and by the worst tensor the first gradient's
        norm and the change's norm after the checked steps, each against
        the reference's norm of that tensor or of the median tensor,
        whichever is larger. Tensors whose reference gradient is under a
        thousandth of the median tensor's move by round-off alone under
        Adam: they are left out of the change."""
        r_losses, r_first, r_after = ref
        loss = [abs(a - b) / abs(b) for a, b in zip(losses, r_losses)]
        g_ref = {k: float(v.norm()) for k, v in r_first.items()}
        g_med = statistics.median(g_ref.values())
        grad = {k: abs(float(first[k].norm()) - g_ref[k]) / max(g_ref[k], g_med) for k in g_ref}
        moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
        d_ref = {k: float((r_after[k] - self.weights[k]).norm()) for k in moved}
        d_med = statistics.median(d_ref.values())
        delta = {k: abs(float((after[k] - self.weights[k]).norm()) - d_ref[k]) / max(d_ref[k], d_med)
                 for k in moved}
        worst_g, worst_d = max(grad, key=grad.get), max(delta, key=delta.get)
        print(f"train check: losses {losses} reference {r_losses}; first gradient worst {worst_g} "
              f"{grad[worst_g]!r}; change worst {worst_d} {delta[worst_d]!r}, median tensor "
              f"{statistics.median(delta.values())!r}; left out {sorted(set(g_ref) - set(moved))}", file=sys.stderr)
        return {"loss1_rel": loss[0], "loss_rel": max(loss), "grad1_leaf_rel": grad[worst_g],
                "grad1_median_rel": statistics.median(grad.values()), "change_leaf_rel": delta[worst_d],
                "change_median_rel": statistics.median(delta.values())}

    def check(self) -> Dict[str, float]:
        return self._compare(self.losses, self.first_grad, self.after, self._reference())

    def control(self, q) -> Dict[str, float]:
        losses, first, after = self._reference(q)
        return self._compare(losses, first, after, self._reference())
