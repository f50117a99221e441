#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py [--out results.json]

Phases, each printing its own lines:

1. environment: the card's name and power limit, the torch and CUDA versions,
   and the TF32 switches, which are set to False so that the fp32 checks run
   in full fp32 (cuDNN convolutions default to TF32);
2. build: the hand-written kernels from ``show_and_tell_tpu_torch/csrc/``,
   one ``nvcc`` per source, all started together, and beside them the metric
   suite's C++ scorers (``csrc/*.cpp``, one ``g++`` each, into
   ``show_and_tell_tpu_torch/_build/native/``); a failed build fails the run;
   the data pipeline's C++ image decoder is built beside them, and whether
   it built (it needs libjpeg and libpng) is printed, not held;
3. each of the seven kernels against its plain PyTorch version on the card, at
   the serving shapes, at phase 9's (the cell at B=64 and 192, the
   attentions at B=64) and at unaligned and ragged ones (the cell: B=300,
   I=H=1000, B=1; the attentions and the scores: K=1, 2, 4 and 8, B=1, L=1,
   13, 64 and 197, D=36, 1000 and 1024, unaligned views, and the first
   kernels of rows 2 and 4-6 by name), in fp32 and bf16, each line naming the
   design that ran (the cell's ``wgmma`` or ``tiled`` kernel, the beam
   attention's cluster size and loads, the per-row attention's and the
   (image, beam) grid's ``onepass<C>`` or ``direct``, the transposed form's
   ``cluster<C>`` or ``direct``, the scores' ``stream<S>`` or ``direct``, the
   probe's tanh form; the forms of the probe that do not meet the tolerance
   are printed, not held): every output
   within an absolute tolerance and, relative to the output's own scale (max
   |diff| / max |plain|), within a relative one, so that small outputs such
   as the context (a mean over L) are held as tightly as large ones; every
   variant name of the beam attention; and the two autograd Functions that
   training runs (the cell and the per-row attention: the kernel forward, a
   plain recompute backward), whose input gradients at the training shapes
   are held against autograd through the plain versions (fp32; bf16
   printed);
4. each kernel's time at the serving shapes in bf16 (CUDA events, L2 flushed
   and the card held busy ~1 ms before every call so that the host has
   queued the whole call before it starts: device time, not the host's
   launch pace; median), beside its bound (the largest of the bytes at the
   memory rate, the plain operations at the fp32 rate and the tanh and exp
   at the special-function rate, each printed), the plain version's time
   (also printed host-paced, without the head start) and, for the cell,
   ``torch.lstm_cell``'s as a yardstick, with the design that ran; the ce
   transpose that the ``st_*`` variants pay per call is timed apart; the
   first (``direct``) kernels of the per-row attention, the (image, beam)
   grid, the transposed form and the scores, and the cluster kernel at K=1,
   are timed beside the design the plan picks, each with its share of the
   bound; the tanh probe is timed per tanh form, with its tanh per second
   beside the special-function rate assumed in the bounds and a plain read
   of the same ce, and then runs the JAX benchmark's probe loop (20 steps,
   each feeding the next step's hp), its launches counted;
5. serving: ``Captioner`` at the model's full width (VGG16 at 224 px,
   E=512, H=1024, V=10000, random weights from a seed, bf16) captions 256
   uint8 images by beam-3 and by greedy decoding; the kernel launch counts
   are reset before and read after each mode, and each batch must have
   launched the cell's ``wgmma`` design and its attention kernel once per
   step (20 each; greedy by the per-row attention's one-pass design); the
   time splits into trunk
   and decode, and one decode per mode is traced with torch.profiler
   (device busy share, top kernels); the decode step's logits through the
   kernels are held against the plain path (the same weights on the CPU,
   where every op runs its plain version, fed the card's features) in fp32
   and in bf16;
6. the beam-route decode chain: with the same model's weights and the
   features of the same images, 20 steps of h-projection, beam attention by
   one route (``s16_cmxu``, ``grid2``, ``st_cmxu``, ``hybrid-s16``), the
   cell and the head, the argmax feeding the next step; per route the ms per
   step (least and median of 10 decodes, and how much of it the host spends
   queueing the launches), its kernel's launches (20; ``hybrid-s16`` by the
   scores' streaming design, ``grid2`` by the one-pass design, ``st_cmxu``
   by the transposed form's cluster design), its step logits against the
   default route's,
   and one traced decode (device busy share, top kernels);
7. training: the Show-Attend-Tell train step at full width (bf16, batch 256,
   T=20, uint8 images with synthetic captions from the seed): warm steps,
   then timed steps on one fixed batch (img/s), the split into trunk,
   forward, backward and optimizer, one traced step (device busy share, top
   kernels), the launches per step (19 of the cell, all by its ``wgmma``
   design, and 19 of the per-row attention, all by its one-pass design), the
   loss finite and falling,
   and one fp32 step whose
   gradients through the kernels are held against the plain path's on the
   card;
8. the rest of serving, on phase 5's 256 images and weights: the serving
   model saved by ``ckpt.save_best`` and its trunk as a torchvision state
   dict, read back by ``Captioner.from_checkpoint`` (beam and greedy captions
   identical to phase 5's); phase 7's train state saved and loaded (every
   tensor equal, the count and the step); then, each timed as the median of
   3 calls after a warmup with its launches counted, sampling (temperature
   1, top-p 0.9: two calls differ, a fresh Captioner replays the first; the
   cell by ``wgmma`` and the per-row attention by ``onepass1``, 20 each per
   batch), n-best (the beam attention 20 per batch; the best of each list is
   the beam caption, scores not increasing) and attention maps ([256, 20,
   196] fp32 rows summing to 1, captions equal to greedy's); top-k 1 held
   equal to greedy on an fp32 Captioner of the same weights, and in bf16,
   where the filter keeps tied top logits and draws among them, replayed with
   each step's logits recorded: every drawn token's logit is its step's
   largest, and a caption leaves greedy's only at a tie;
9. the eval driver on a trained decoder, at phase 5's width: the JAX
   benchmark's synthetic scenes (18 classes, 5 caption templates each, 256
   training and 256 held-out uint8 images from the seed); the port's
   ``evalsuite.driver.evaluation`` in beam and greedy mode over 4 batches of
   64 held-out images (the trunk, the loss, the decode, the one-batch lag and
   ``language_eval`` against a COCO-format annotation file), first with the
   random weights, then after 200 ``TrainStep`` steps at lr 3e-3 on the
   training scenes' trunk features: the validation loss, every metric, the
   exact-caption rate, the mean caption length, the decode steps each batch
   took (from the launch counts), img/s with and without ``language_eval``
   and the launches of rows 1-3; held: the native scorers live and equal to
   the pure-Python path per image, the kernels launched, the trained
   decoder's early exit and its CIDEr at least 10x the untrained one's and at
   least 1, and the fp32 greedy ids through the kernels equal to the plain
   path's but at ties (top-two logit gap under 1e-4);
10. the training CLI on the card, at phase 5's width, the way a training
   user runs it: a Karpathy-format caption JSON of phase 9's scenes (256
   training scenes with their class's 5 templates, 256 held-out scenes with
   a COCO annotation file of the 5, filler captions that bring the
   vocabulary to 10,000) through ``cli.preprocess``; the scenes' pixels
   written as memmap shards in the documented layout (the card's host has
   no image codec) and reused by ``pack_memmap``; one epoch of the loader
   alone (host img/s); ``cli.main.main(cfg)``: 40 epochs of 5 steps at
   batch 256, lr 3e-3, a greedy CIDEr gate every 50 steps, the trunk from a
   torchvision-layout file (``--encoder_weights``), printing each log
   line's loss, each gate's CIDEr and seconds, the trainer's img/s and
   ms/step beside phase 7's bare-step img/s, and holding the loss finite
   and falling, rows 1 and 2 launched pad_len - 1 times per step by the
   cell's ``wgmma`` and the attention's one-pass design, the infos'
   iteration, epoch and best score, the best checkpoint at the largest
   CIDEr (at least 1) and no corrupt image substituted; a ``Trainer``
   preempted mid-epoch and resumed through ``start_from`` (the trained
   plans skipped, the first batch the uninterrupted order's, the same end);
   ``cli.evaluate`` on the best checkpoint, greedy (lang_stats and the first
   10 predictions equal to the gate's) and beam 3 (row 3 once per decode
   step); ``cli.extract_features`` over the shards (features within the bf16
   tolerance of ``backbone_features(eval_transform(x))``, img/s), then 10
   ``cli.main`` steps on the features (every batch features [256, 196,
   512], no images);
11. serving over HTTP, the way a serving user runs it: phase 10's best
   checkpoint and trunk file through ``cli.serve_http.make_server`` (bound
   to 127.0.0.1, warmed over every bucket for beam and greedy): PNG bodies
   through the real decode where PIL is importable (and then ``cli.caption``
   over 8 PNG files with contact sheets, and ``?attention=1``), else the
   decode bound to a ``.npy`` reader for the phase; closed-loop clients in a
   process of their own post phase 10's 512
   scenes as batch-1 ``/caption`` requests at 1, 8, 32 and 128 clients, beam
   and greedy (``http.client``, one connection per request), each on a
   fresh server over the one ``Captioner`` (client
   img/s and p50/p95/p99, the batcher's stats, the worker's seconds in
   ``caption_images`` and the handlers' decode seconds, batches per bucket, decode
   steps and launches per batch by design: the cell and the mode's attention
   once per step, nothing else); one ``/caption_batch`` of 256; every HTTP
   caption equal to the direct ``caption_images`` caption of the same image
   at the same bucket, and the HTTP img/s against the direct one; ``?nbest=1``
   headed by the beam caption, a burst answered with 429s that ``stats()``
   counts, ``/healthz``, ``/metrics`` counters equal to the requests, every
   batcher's worker gone after ``server_close()``; ``cli.export_torch`` on
   the checkpoint, its ``.pth`` served through ``cfg.torch_checkpoint`` with
   the same captions; ``cli.train_chain`` over two epochs as child
   processes on the card (seconds per child);
12. Show-and-Tell on the card (phases 3 and 4 also hold and time the cell at
   its layer-0 shapes, I=512): the ``Config`` defaults with
   ``model="show_tell"`` (ResNet-152, crop 224, E=512, H=1024, one layer,
   V=10,000, bf16) served by the ``Captioner`` over phase 5's 256 images,
   beam-3 and greedy (img/s, the cell's launches per batch: a layer per
   decode step, by ``wgmma``, and no attention kernel; greedy's launches
   against the steps its ids show; trunk and decode apart, the trunk's
   device time beside its bound, a traced decode), the decode-step logits
   against the same weights on the CPU (bf16 and fp32, at B and 3B), fp32
   greedy ids against the plain path on the card (differences only at
   ties); ``TrainStep`` at batch 256 (img/s, the split, (T-1) cell
   launches per step, the running statistics after a step against 0.99 old
   + 0.01 the batch's recomputed in float64, the loss falling, a traced
   step, fp32 gradients against the plain path); the trained model through
   ``model-best.pt`` with its statistics and a torchvision ResNet-152 file
   back into a ``Captioner``, and through ``cli.export_torch``'s reference
   ``.pth``, both captioning as the live model; then the scaled
   configuration (Inception-v3 at crop 299, two layers) at batch 64 of
   342-px images: beam and greedy, the logits against the CPU, one train
   step.
13. the int8 trunk (``Config.quantize_backbone``: per-channel int8 weights,
   calibrated activation scales, an NHWC im2col over ``torch._int_mm``) on
   the card: ``torch._int_mm``'s limits; Show-Attend-Tell on VGG16 with
   phase 9's trained decoder over its 256 held-out scenes (the calibration's
   seconds on 32 training scenes, int8 beam-3 and greedy img/s beside bf16's,
   ``bench.py``'s quality gate re-stated here: int8 / bf16 exact-caption rate
   >= 0.90 and CIDEr >= 0.95 in both modes, else it raises; the int8 trunk's
   device time beside its bound, the int8 operations its GEMMs do at 1,979
   TOPS, and the bf16 trunk; peak memory; a traced trunk; the feature cosine
   against the fp32 trunk), ``warmup()`` without calibration images leaving
   the trunk float, a second ``Captioner`` on ``quantized_backbone_path``
   loading the same scales; Show-and-Tell on ResNet-152 over phase 5's
   images (img/s, captions equal to bf16's, the trunk beside its bound and
   phase 12's bf16 trunk, the cosine); the scaled Inception-v3 (299 px, two
   layers, batch 64); ``cli.evaluate`` and ``cli.main`` (a ``Trainer`` that
   calibrates on its first batch and takes phase 10's five steps, losses
   finite) with ``--quantize_backbone`` on phase 10's corpus.
Phases 8-11 count their launches in their own lines and the ``--out``
file's; the kernels line counts phases 4-6 as before, phase 12's launches
of the cell on its main path, and phase 13's launches of the cell and the
attentions on the int8 runs.

The line before the last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. Any failed check raises, and the
script exits non-zero. Without CUDA it exits non-zero before any result.
"""

from __future__ import annotations

import argparse
import base64
import concurrent.futures
import contextlib
import http.client
import inspect
import io
import json
import logging
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # fp32: CUDA cores
# tanh, exp and reciprocal run on the special-function units: 16 operations
# per clock per SM, 132 SMs, at the 1.98 GHz boost clock
PEAK_SFU_PER_S = 16 * 132 * 1.98e9
# special-function operations per tanh by the probe's form: tanh.approx.bf16x2
# runs as two MUFU.TANH.BF16, one per half (phase 2 counts them in the
# probe's machine code), so no form does better than one per tanh; the
# precise tanhf is a sequence the compiler picks and is not counted
SFU_PER_TANH = {"bf16x2": 1.0, "approx_f32": 1.0, "ex2_rcp": 2.0, "precise": None}

SEED = 0
# kernel vs plain version: max |diff| per output, absolute ...
TOL = {torch.float32: {"lstm_cell": 1e-5, "attention": 2e-5},
       torch.bfloat16: {"lstm_cell": 2e-2, "attention": 2e-2}}
# ... and relative to the output's scale, max |diff| / max |plain|
RTOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# the probe's output is a sum of K * L tanh (588 at the serving shape, up to
# ~540 in size), so it is held relative to its scale and, in fp32, within
# 2e-3: 588 terms of size <= 1 summed in another order, each tanh within 5e-7.
# In bf16 each tanh.approx.bf16x2 may sit one bf16 step (2^-8) from the plain
# version's and the sum reads up to 4e-3 of its scale; 5e-3 of the scale is
# 2.7 at the serving shape, under the 3 that one dropped patch row can cost.
PROBE_TOL = {torch.float32: 2e-3, torch.bfloat16: float("inf")}
PROBE_RTOL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}
REPS = 3  # timed Captioner calls per decode mode
# decode-step logits of the kernel path vs the plain path, relative to the
# logit scale
LOGITS_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# cycles of torch.cuda._sleep before each timed call: ~1 ms at the H100's
# 1.98 GHz, longer than the host takes to queue the plain versions' launches
HEAD_START_CYCLES = 2_000_000

# autograd Functions: input gradients through the kernel path against
# autograd through the plain path, max |diff| / max |plain grad|
GRAD_RTOL = 1e-4
STEPS = 20  # decode steps of the beam-route chain, and of the probe's loop
# the tanh forms of the probe held against the plain version; tanh.approx.f32
# (~2^-11 relative error) is printed, and held only where bf16 rounds it away
PROBE_HELD = {torch.float32: ("ex2_rcp", "precise"),
              torch.bfloat16: ("bf16x2", "approx_f32", "ex2_rcp", "precise")}
CHAIN_REPS = 10  # timed decodes per route of the beam-route chain
WARM_STEPS, TIMED_STEPS = 2, 10  # training steps

REPLACES = {
    "lstm_cell": "show_and_tell_tpu/ops/lstm.py:109",
    "additive_attention": "show_and_tell_tpu/ops/fused_attention.py:49",
    "attention_beam": "show_and_tell_tpu/ops/fused_decode_attention.py:167",
    "attention_beam_grid2": "show_and_tell_tpu/ops/fused_decode_attention.py:140",
    "attention_beam_st": "show_and_tell_tpu/ops/fused_decode_attention.py:108",
    "attention_scores": "show_and_tell_tpu/ops/fused_decode_attention.py:339",
    "tanh_probe": "benchmarks/attn_kernel_bench.py:149",
}
_BEAM_CU = "show_and_tell_tpu_torch/csrc/beam_attention.cu"
SOURCES = {
    "lstm_cell": "show_and_tell_tpu_torch/csrc/lstm_cell.cu",
    "additive_attention": "show_and_tell_tpu_torch/csrc/additive_attention.cu",
    "attention_beam": "show_and_tell_tpu_torch/csrc/decode_attention.cu",
    "attention_beam_grid2": "show_and_tell_tpu_torch/csrc/additive_attention.cu",
    "attention_beam_st": _BEAM_CU,
    "attention_scores": _BEAM_CU,
    "tanh_probe": "show_and_tell_tpu_torch/csrc/tanh_probe.cu",
}


def _gen(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def _randn(shape, g, dtype, scale=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def _uniform(shape, g, dtype, bound):
    return ((torch.rand(shape, generator=g, device="cuda") * 2 - 1) * bound).to(dtype)


def _maxdiff(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def _diffs(out: torch.Tensor, ref: torch.Tensor):
    """(max |diff|, max |diff| / max |ref|)."""
    d = _maxdiff(out, ref)
    return d, d / ref.float().abs().max().item()


# --- inputs at a shape ------------------------------------------------------


def cell_inputs(B, I, H, dtype, seed):
    g = _gen(seed)
    k = H ** -0.5
    params = {"w": _uniform((I + H, 4 * H), g, dtype, k), "b": _uniform((4 * H,), g, torch.float32, k)}
    x = _randn((B, I), g, dtype)
    h = _randn((B, H), g, dtype)
    c = _randn((B, H), g, torch.float32)
    return params, x, h, c


def attention_inputs(B, K, L, D, dtype, seed):
    g = _gen(seed)
    ce = _randn((B, L, D), g, dtype)
    f = _randn((B, L, D), g, dtype)
    hp = _randn((B, K, D), g, dtype)
    watt = _uniform((D,), g, dtype, (6.0 / (D + 1)) ** 0.5)
    return ce, f, hp, watt


# --- bounds -----------------------------------------------------------------


def cell_bound(B, I, H, dtype):
    es = torch.tensor([], dtype=dtype).element_size()
    flops = 2.0 * B * (I + H) * 4 * H
    nbytes = (B * I + B * H + (I + H) * 4 * H) * es + 4 * H * 4 + B * H * 4  # in: x h W b c
    nbytes += B * H * es + B * H * 4  # out: h' c'
    return _bound(flops, nbytes, dtype)


def attention_bound(B, K, L, D, dtype):
    es = torch.tensor([], dtype=dtype).element_size()
    # per (b, k, l, d): an add and a multiply-add for the score and a
    # multiply-add for the context on the fp32 pipe; a tanh, and per
    # (b, k, l) an exp, on the special-function units, one operation each
    # (no form of the tanh does better: SFU_PER_TANH)
    ops = 5.0 * B * K * L * D
    sfu = 1.0 * B * K * L * D + B * K * L
    nbytes = (2 * B * L * D + B * K * D + D) * es  # in: ce f hp w_att
    nbytes += B * K * D * es + B * K * L * 4  # out: ctx alpha
    return _bound(ops, nbytes, torch.float32, sfu)


def scores_bound(B, K, L, D, dtype):
    es = torch.tensor([], dtype=dtype).element_size()
    ops = 3.0 * B * K * L * D  # add, multiply-add per (b, k, l, d), fp32
    nbytes = (B * L * D + B * K * D + D) * es + B * K * L * 4  # in: ce hp w_att; out: e
    return _bound(ops, nbytes, torch.float32, 1.0 * B * K * L * D)


def probe_bound(B, K, L, D, dtype):
    es = torch.tensor([], dtype=dtype).element_size()
    ops = 2.0 * B * K * L * D  # add, accumulate per (b, k, l, d), fp32
    nbytes = (B * L * D + B * K * D) * es + B * D * 4  # in: ce hp; out
    return _bound(ops, nbytes, torch.float32, 1.0 * B * K * L * D)


def _bound(ops, nbytes, op_dtype, sfu=0.0):
    """(ms, "bytes" or "operations", which operations, the three times as
    text): the largest of the bytes at the memory rate, the plain operations
    at their pipe's rate and the special-function operations at theirs."""
    t_ops = ops / PEAK_FLOPS[op_dtype] * 1e3
    t_sfu = sfu / PEAK_SFU_PER_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    parts = f"bytes {t_bytes:.4f}, operations {t_ops:.4f}" + (f", special-function {t_sfu:.4f}" if sfu else "")
    if t_bytes >= max(t_ops, t_sfu):
        return t_bytes, "bytes", None, parts
    if t_sfu > t_ops:
        return t_sfu, "operations", "special-function", parts
    return t_ops, "operations", str(op_dtype).replace("torch.", ""), parts


# --- timing -----------------------------------------------------------------


def time_cold(fn, iters=30, warmup=3, head_start=True, flush_by="write") -> float:
    """Median ms of one call, with L2 flushed before each: in the decode
    loop the attention streams ~100 MB between two calls of any kernel.
    With ``head_start`` the card spins before each call, so that the host
    has queued all of the call's launches when the first event fires and
    the time is the device's; without it a call of many small launches is
    timed at the pace at which the host launches them. ``flush_by``: "write"
    zeroes 256 MB, which leaves L2 full of dirty lines that the timed call
    has to write back as it evicts them (the times of every table); "read"
    reads 256 MB, which leaves clean lines."""
    flush = torch.zeros(256 << 20, dtype=torch.uint8, device="cuda")
    words = flush.view(torch.int32)
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        if flush_by == "write":
            flush.zero_()
        else:
            words.max()
        if head_start:
            torch.cuda._sleep(HEAD_START_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    times = [a.elapsed_time(b) for a, b in pairs]
    return statistics.median(times)


def profile_window(fn, mode, top=8):
    """Device busy share of one call of ``fn`` (the sum of kernel times over
    the wall time of the traced window) and its most expensive kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not kernels or busy_us == 0:
        print(f"  {mode:6s} profile: the trace holds no device time (not measured)")
        return
    print(f"  {mode:6s} profile: wall {wall_us / 1e3:.2f} ms, kernels {busy_us / 1e3:.2f} ms, "
          f"device busy {busy_us / wall_us:.1%}, idle {1 - busy_us / wall_us:.1%}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms  {e.count:5d}x  {e.key[:90]}")


# --- phases -----------------------------------------------------------------


def phase_environment():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print("== 1. environment")
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  python {sys.version.split()[0]}")
    print(f"device 0: {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    print(
        "TF32 as found: cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
    )
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 set to False for the fp32 checks: cudnn.allow_tf32=False cuda.matmul.allow_tf32=False")
    print("card name, power limit:")
    print(smi)
    return smi


def phase_build():
    from show_and_tell_tpu_torch.ops import cuda_lib
    from show_and_tell_tpu_torch.utils import native

    print("== 2. build")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        scorers = pool.submit(native.build)  # the g++ builds beside the nvcc ones
        # the data pipeline's C++ image decoder needs libjpeg and libpng on
        # the host: its build is reported, not held
        decoder = pool.submit(native.build, ("libimage_loader.so",))
        secs = cuda_lib.build_all()
        native_secs = scorers.result()
        try:
            decoder_note = f"built in {decoder.result():.1f} s"
        except RuntimeError as e:
            decoder_note = f"not built (the pipeline decodes with PIL where it has one): {str(e).splitlines()[-1][:200]}"
    print(f"built {', '.join(cuda_lib.SOURCES)} for sm_90a in {secs:.1f} s")
    print(f"built the native scorers ({', '.join(native.SOURCES[so] for so in native.SCORER_LIBS)}) with g++ in "
          f"{native_secs:.1f} s, "
          f"into {os.path.relpath(native.BUILD_DIR)}")
    print(f"the data pipeline's C++ image decoder (csrc/image_loader.cpp, -ljpeg -lpng): {decoder_note}")
    for src, log in cuda_lib.build_logs().items():
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", log)]
        print(f"  {src}: {len(regs)} kernels, registers {min(regs)}-{max(regs)}, "
              f"spill stores at most {max(spills)} bytes (ptxas -v)")
    print(f"  {mufu_per_pair()}")


def mufu_per_pair() -> str:
    """How many special-function instructions ``tanh.approx.bf16x2`` became:
    the MUFU.TANH in the machine code of the probe's bf16x2 kernel (16-byte
    vectors) over the pairs of elements its source forms a tanh of (two
    batches of U rows of 4 pairs, the loop over k not unrolled). The bounds
    count one operation per tanh (SFU_PER_TANH), two per pair: where the
    toolkit has ``cuobjdump``, any other count raises."""
    from show_and_tell_tpu_torch.ops import cuda_lib

    what = "tanh.approx.bf16x2 in the probe's machine code"
    tool = os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return f"{what}: no cuobjdump (not measured)"
    with open(os.path.join(cuda_lib.CSRC, "tanh_probe.cu")) as fh:
        pairs = 2 * int(re.search(r"constexpr int U = (\d+);", fh.read()).group(1)) * 4
    sass = subprocess.run([tool, "-sass", cuda_lib._lib_path("tanh_probe.cu")],
                          capture_output=True, text=True, timeout=120).stdout
    for fn in sass.split("Function : ")[1:]:
        if "Li8ELi0E" in fn.split("\n", 1)[0]:  # <bf16, VEC = 8, FORM = BF16X2>
            n = len(re.findall(r"MUFU\.TANH", fn))
            assert n == 2 * SFU_PER_TANH["bf16x2"] * pairs, \
                f"{what}: {n} MUFU.TANH for {pairs} pairs; the bounds assume {SFU_PER_TANH['bf16x2']:g} per tanh"
            return (f"{what}: {n} MUFU.TANH for {pairs} pairs of elements = "
                    f"{n / pairs:g} special-function operations per pair of tanh")
    raise AssertionError(f"{what}: the bf16x2 kernel is not in the library")


def _design(name: str) -> str:
    """The designs of kernel ``name`` launched since the counts were cleared."""
    from show_and_tell_tpu_torch.ops import cuda_lib

    return ",".join(cuda_lib.designs(name)) or "-"


def phase_check():
    from show_and_tell_tpu_torch.ops import cuda_lib
    from show_and_tell_tpu_torch.ops import fused_attention as fa
    from show_and_tell_tpu_torch.ops import fused_decode_attention as fda
    from show_and_tell_tpu_torch.ops import lstm
    from show_and_tell_tpu_torch.ops import tanh_probe as tp

    print("== 3. kernels against their plain versions")
    errs = {}  # name -> max abs err at the serving shape in bf16
    failures = []

    def report(name, shape, dtype, pairs, tol, serving, design="", held=True, rtol=None):
        """pairs: output name -> (kernel's output, plain version's). A line
        that is not ``held`` is printed and cannot fail."""
        diffs = {k: _diffs(out, ref) for k, (out, ref) in pairs.items()}
        worst = max(d for d, _ in diffs.values())
        worst_rel = max(r for _, r in diffs.values())
        rtol = RTOL[dtype] if rtol is None else rtol
        ok = worst <= tol and worst_rel <= rtol
        dname = str(dtype).replace("torch.", "")
        parts = " ".join(f"{k}={d:.3e} (rel {r:.2e})" for k, (d, r) in diffs.items())
        verdict = ("ok" if ok else "FAIL") if held else "(printed)"
        print(f"  {name:19s} {shape:26s} {dname:8s} {design:15s} max|diff| {parts}  tol {tol:g} rel {rtol:g}  "
              f"{verdict}")
        if held and not ok:
            failures.append(f"{name} {shape} {dname} {design}")
        if serving and dtype == torch.bfloat16:
            errs[name] = max(errs.get(name, 0.0), worst)

    for dtype in (torch.float32, torch.bfloat16):
        # the serving shapes, phase 9's (the eval driver's 64 images: B=64
        # greedy and loss, B=192 beam), then: ragged B, ragged H and k-tiles
        # on the TMA path, one row; ragged H, I+H not a multiple of the
        # k-tile, and I not a multiple of the vector width (element-wise loads);
        # Show-and-Tell's layer 0 (phase 12: I=512 at B=768 and 256; B=192 and
        # 64 for its scaled configuration)
        for B, I, H, serving in ((768, 1024, 1024, True), (256, 1024, 1024, True),
                                 (768, 512, 1024, False), (256, 512, 1024, False),
                                 (192, 512, 1024, False), (64, 512, 1024, False),
                                 (64, 1024, 1024, False), (192, 1024, 1024, False),
                                 (300, 1024, 1024, False), (64, 1000, 1000, False),
                                 (1, 1024, 1024, False), (13, 40, 24, False), (9, 48, 40, False),
                                 (5, 17, 20, False)):
            p, x, h, c = cell_inputs(B, I, H, dtype, SEED)
            cuda_lib.LAUNCHES.clear()
            hk, ck = lstm.lstm_cell_cuda(p, x, h, c)
            design = _design("lstm_cell")
            hr, cr = lstm.lstm_cell_reference(p, x, h, c)
            assert hk.dtype == dtype and ck.dtype == torch.float32
            report("lstm_cell", f"B={B} I={I} H={H}", dtype,
                   {"h": (hk, hr), "c": (ck, cr)}, TOL[dtype]["lstm_cell"], serving, design)
        # the attentions: K = 2..8, one patch row, one image, rows longer
        # than one pass of registers (D=1024), L=13, D=36; the per-row
        # attention also at L=197 (three blocks per image), D=1000 and a
        # shape its one-pass design does not take (72-byte rows)
        for name, B, K, L, D, serving in (
            ("additive_attention", 256, 1, 196, 512, True),
            ("additive_attention", 64, 1, 196, 512, False),  # phase 9's batch: several blocks per image
            ("additive_attention", 7, 1, 13, 40, False),
            ("additive_attention", 1, 1, 196, 512, False),
            ("additive_attention", 256, 1, 1, 512, False),
            ("additive_attention", 256, 1, 13, 512, False),
            ("additive_attention", 64, 1, 197, 512, False),
            ("additive_attention", 16, 1, 196, 1000, False),
            ("additive_attention", 16, 1, 196, 1024, False),
            ("additive_attention", 5, 1, 13, 36, False),
            ("attention_beam", 256, 3, 196, 512, True),
            ("attention_beam", 64, 3, 196, 512, False),  # phase 9's batch
            ("attention_beam", 256, 2, 196, 512, False),
            ("attention_beam", 256, 4, 196, 512, False),
            ("attention_beam", 256, 8, 196, 512, False),
            ("attention_beam", 256, 3, 1, 512, False),
            ("attention_beam", 1, 3, 196, 512, False),
            ("attention_beam", 16, 3, 49, 1024, False),
            ("attention_beam", 256, 3, 13, 512, False),
            ("attention_beam", 5, 3, 13, 36, False),
        ):
            ce, f, hp, watt = attention_inputs(B, K, L, D, dtype, SEED + 1)
            cuda_lib.LAUNCHES.clear()
            if K == 1:
                ck, ak = fa.fused_attention(ce, f, hp[:, 0], watt)
                cr, ar = fa.attention_reference(ce, f, hp[:, 0], watt)
            else:
                ck, ak = fda.attention_beam(ce, f, hp, watt)
                cr, ar = fda.attention_beam_reference(ce, f, hp, watt)
            design = _design(name)
            assert ck.dtype == dtype and ak.dtype == torch.float32
            report(name, f"B={B} K={K} L={L} D={D}", dtype,
                   {"ctx": (ck, cr), "alpha": (ak, ar)}, TOL[dtype]["attention"], serving, design)
        # the per-row attention at the serving shape by the kernels that phase
        # 4 times beside the plan's (the first kernel, and the cluster kernel
        # at K=1), and on an unaligned view, which must take the direct design
        B, L, D = 256, 196, 512
        ce, f, hp, watt = attention_inputs(B, 1, L, D, dtype, SEED + 1)
        hp1 = hp[:, 0].contiguous()
        cr, ar = fa.attention_reference(ce, f, hp1, watt)
        shape, tol = f"B={B} K=1 L={L} D={D}", TOL[dtype]["attention"]
        cuda_lib.LAUNCHES.clear()
        ck, ak = fa.launch_attention("additive_attention", ce, f, hp, watt)
        report("additive_attention", shape, dtype, {"ctx": (ck[:, 0], cr), "alpha": (ak[:, 0], ar)}, tol, False,
               _design("additive_attention"))
        cuda_lib.LAUNCHES.clear()
        ck, ak = fda.attention_beam_cluster(ce, f, hp, watt)
        report("attention_beam", shape, dtype, {"ctx": (ck[:, 0], cr), "alpha": (ak[:, 0], ar)}, tol, False,
               _design("attention_beam"))
        off = _randn((B * L * D + 8,), _gen(SEED + 6), dtype)[1:1 + B * L * D].view(B, L, D)
        assert off.is_contiguous() and off.data_ptr() % 16
        cro, aro = fa.attention_reference(off, f, hp1, watt)
        cuda_lib.LAUNCHES.clear()
        ck, ak = fa.fused_attention(off, f, hp1, watt)
        design = _design("additive_attention")
        assert design == "direct", design
        report("additive_attention", shape + " view", dtype, {"ctx": (ck, cro), "alpha": (ak, aro)}, tol, False,
               design)
        # rows 4-6, through the public API by variant name, each by the design
        # its plan picks; the scores are held like alpha, and the hybrid's
        # plain softmax and context beside
        for B, K, L, D, serving in ((256, 3, 196, 512, True), (256, 3, 13, 512, False),
                                    (5, 3, 13, 36, False), (1, 3, 196, 512, False),
                                    (256, 3, 1, 512, False), (64, 3, 197, 512, False),
                                    (16, 3, 196, 1000, False), (16, 3, 196, 1024, False),
                                    (256, 1, 196, 512, False), (64, 8, 196, 512, False),
                                    (32, 3, 64, 512, False)):
            ce, f, hp, watt = attention_inputs(B, K, L, D, dtype, SEED + 1)
            cr, ar = fda.attention_beam_reference(ce, f, hp, watt)
            shape, tol = f"B={B} K={K} L={L} D={D}", TOL[dtype]["attention"]
            for name, variant in (("attention_beam_grid2", "grid2"), ("attention_beam_st", "st_cmxu")):
                cuda_lib.LAUNCHES.clear()
                ck, ak = fda.attention_beam(ce, f, hp, watt, variant=variant)
                assert ck.dtype == dtype and ak.dtype == torch.float32
                report(name, shape, dtype, {"ctx": (ck, cr), "alpha": (ak, ar)}, tol, serving, _design(name))
            if serving:  # the first kernels by name, and unaligned views, which take them by the plan
                cet = ce.transpose(1, 2).contiguous()
                for name, fn in (("attention_beam_grid2", lambda: fa.launch_attention(name, ce, f, hp, watt)),
                                 ("attention_beam_st", lambda: fda.attention_beam_st_direct(cet, f, hp, watt))):
                    cuda_lib.LAUNCHES.clear()
                    ck, ak = fn()
                    report(name, shape, dtype, {"ctx": (ck, cr), "alpha": (ak, ar)}, tol, False, _design(name))
                for name, variant, x in (("attention_beam_grid2", "grid2", ce), ("attention_beam_st", "st_cmxu", cet)):
                    off = torch.empty(x.numel() + 8, dtype=dtype, device="cuda")[1:1 + x.numel()].view(x.shape)
                    off.copy_(x)
                    assert off.is_contiguous() and off.data_ptr() % 8
                    cuda_lib.LAUNCHES.clear()
                    if variant == "grid2":
                        ck, ak = fda.attention_beam(off, f, hp, watt, variant=variant)
                    else:
                        ck, ak = fda.attention_beam_st(off, f, hp, watt)
                    assert _design(name) == "direct", _design(name)
                    report(name, shape + " view", dtype, {"ctx": (ck, cr), "alpha": (ak, ar)}, tol, False, "direct")
            er = fda.attention_scores_reference(ce, hp, watt)
            cuda_lib.LAUNCHES.clear()
            e = fda.attention_scores(ce, hp, watt, "s16")
            assert e.shape == (B, K, L) and e.dtype == torch.float32
            report("attention_scores", shape, dtype, {"e": (e, er)}, tol, serving, _design("attention_scores"))
            if serving:  # the first kernel; an unaligned view takes it by the plan
                report("attention_scores", shape, dtype, {"e": (fda.attention_scores_direct(ce, hp, watt), er)},
                       tol, False, "direct")
                off = _randn((B * L * D + 8,), _gen(SEED + 6), dtype)[1:1 + B * L * D].view(B, L, D)
                cuda_lib.LAUNCHES.clear()
                e = fda.attention_scores(off, hp, watt, "s16")
                assert _design("attention_scores") == "direct"
                report("attention_scores", shape + " view", dtype,
                       {"e": (e, fda.attention_scores_reference(off, hp, watt))}, tol, False, "direct")
            ch, ah = fda.attention_beam_hybrid(ce, f, hp, watt, "s16")
            report("  hybrid-s16", shape, dtype, {"ctx": (ch, cr), "alpha": (ah, ar)}, tol, False)
        # every variant name runs its kernel and agrees with the plain version
        ce, f, hp, watt = attention_inputs(5, 3, 13, 36, dtype, SEED + 2)
        cr, ar = fda.attention_beam_reference(ce, f, hp, watt)
        for variant in fda.VARIANTS:
            ck, ak = fda.attention_beam(ce, f, hp, watt, variant=variant)
            report(f"  {variant}", "B=5 K=3 L=13 D=36", dtype,
                   {"ctx": (ck, cr), "alpha": (ak, ar)}, TOL[dtype]["attention"], False)
        for variant in fda.SCORE_VARIANTS:
            ch, ah = fda.attention_beam_hybrid(ce, f, hp, watt, variant)
            report(f"  hybrid-{variant}", "B=5 K=3 L=13 D=36", dtype,
                   {"ctx": (ch, cr), "alpha": (ah, ar)}, TOL[dtype]["attention"], False)
        # the probe: the serving shape by every tanh form (held: the forms
        # that meet the dtype's tolerance), and edge shapes by the default:
        # rows without 16-byte vectors (one element per thread), L=197 and
        # D=1000 (a ragged last batch of rows and last block), one patch row
        for B, K, L, D, serving in ((256, 3, 196, 512, True), (5, 3, 13, 36, False),
                                    (3, 2, 197, 1000, False), (2, 8, 1, 520, False)):
            g = _gen(SEED + 7)
            ce, hp = _randn((B, L, D), g, dtype), _randn((B, K, D), g, dtype)
            forms = [n for n in tp.TANH_FORMS if n != "bf16x2" or dtype == torch.bfloat16] if serving else [None]
            for form in forms:
                ref = tp.tanh_probe_reference(ce, hp)
                out = tp.tanh_probe(ce, hp, form)
                assert out.shape == (B, D) and out.dtype == torch.float32
                held = form is None or form in PROBE_HELD[dtype]
                report("tanh_probe", f"B={B} K={K} L={L} D={D}", dtype, {"out": (out, ref)}, PROBE_TOL[dtype],
                       serving and form == tp.DEFAULT_FORM[dtype], form or tp.DEFAULT_FORM[dtype], held,
                       PROBE_RTOL[dtype])
    torch.cuda.synchronize()
    failures += check_functions()
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: {failures}")
    return errs


def _input_grads(fn, leaves, weights):
    """Gradients of sum_i <out_i, weights_i> with respect to ``leaves``."""
    outs = fn(*leaves)
    loss = sum((o.float() * w.float()).sum() for o, w in zip(outs, weights))
    return torch.autograd.grad(loss, leaves)


def check_functions():
    """The two autograd Functions of training at the training shapes: input
    gradients through the kernel forward and the recompute backward, against
    autograd through the plain version on the same inputs. Held in fp32;
    printed in bf16. Returns the failures."""
    from show_and_tell_tpu_torch.ops import fused_attention as fa
    from show_and_tell_tpu_torch.ops import lstm

    print(f"  autograd Functions, input gradients vs autograd through the plain version "
          f"(max|diff| / max|plain grad|, fp32 limit {GRAD_RTOL:g})")
    failures = []
    cell_fn = lstm.LSTMCellFunction.apply

    def cell_plain(w, b, x, h, c):
        return lstm.lstm_cell_reference({"w": w, "b": b}, x, h, c)

    for dtype in (torch.float32, torch.bfloat16):
        B, I, H, L, D = 256, 1024, 1024, 196, 512
        p, x, h, c = cell_inputs(B, I, H, dtype, SEED + 3)
        g = _gen(SEED + 4)
        cases = [
            ("LSTMCellFunction", f"B={B} I={I} H={H}", cell_fn, cell_plain,
             (p["w"], p["b"], x, h, c), ("w", "b", "x", "h", "c"),
             (_randn((B, H), g, dtype), _randn((B, H), g, torch.float32))),
        ]
        ce, f, hp, watt = attention_inputs(B, 1, L, D, dtype, SEED + 5)
        cases.append(("FusedAttentionFunction", f"B={B} L={L} D={D}", fa.FusedAttentionFunction.apply,
                      fa.attention_reference, (ce, f, hp[:, 0].contiguous(), watt),
                      ("ce", "f", "hp", "w_att"),
                      (_randn((B, D), g, dtype), _randn((B, L), g, torch.float32))))
        dname = str(dtype).replace("torch.", "")
        for name, shape, fn, plain, ins, names, weights in cases:
            gk = _input_grads(fn, [t.clone().requires_grad_() for t in ins], weights)
            gp = _input_grads(plain, [t.clone().requires_grad_() for t in ins], weights)
            rel = {n: _diffs(a, b)[1] for n, a, b in zip(names, gk, gp)}
            worst = max(rel.values())
            ok = worst <= GRAD_RTOL or dtype != torch.float32
            verdict = ("ok" if ok else "FAIL") if dtype == torch.float32 else "(printed)"
            print(f"  {name:22s} {shape:22s} {dname:8s} " + " ".join(f"d{n} {r:.2e}" for n, r in rel.items())
                  + f"  {verdict}")
            if not ok:
                failures.append(f"{name} {dname}")
    torch.cuda.synchronize()
    return failures


def phase_times():
    from show_and_tell_tpu_torch.ops import cuda_lib
    from show_and_tell_tpu_torch.ops import fused_attention as fa
    from show_and_tell_tpu_torch.ops import fused_decode_attention as fda
    from show_and_tell_tpu_torch.ops import lstm
    from show_and_tell_tpu_torch.ops import tanh_probe as tp

    print("== 4. times at the serving shapes, bf16 (median ms, L2 flushed and the card "
          "given a head start before each call)")
    dt = torch.bfloat16
    rows = {}

    def show(name, shape, kernel, plain, bound, library=None):
        """Times ``kernel``, ``plain`` and ``library`` (callables) and prints
        them with the design that the kernel's launches took."""
        bound_ms, bound_by, bound_ops, bound_parts = bound
        by = bound_by + (f": {bound_ops}" if bound_ops else "")
        cuda_lib.LAUNCHES.clear()
        kernel_ms = time_cold(kernel)
        design = _design(name)
        clean_ms = time_cold(kernel, flush_by="read")
        plain_ms = time_cold(plain)
        host_paced_ms = time_cold(plain, head_start=False)
        library_ms = time_cold(library) if library is not None else None
        lib = f"{library_ms:.4f}" if library_ms is not None else "null"
        print(
            f"  {name:19s} {shape:24s} {design:15s} kernel_ms {kernel_ms:.4f} (after a read flush "
            f"{clean_ms:.4f})  bound_ms {bound_ms:.4f} "
            f"({by}, {bound_ms / kernel_ms:.1%} of it; {bound_parts})  plain_ms {plain_ms:.4f} "
            f"(host-paced {host_paced_ms:.4f})  library_ms {lib}"
        )
        return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "bound_operations": bound_ops, "library_ms": library_ms}

    for B in (768, 256):
        I = H = 1024
        p, x, h, c = cell_inputs(B, I, H, dt, SEED)
        w_ih = p["w"][:I].t().contiguous()
        w_hh = p["w"][I:].t().contiguous()
        b_ih = p["b"].to(dt)
        b_hh = torch.zeros_like(b_ih)
        c_lib = c.to(dt)
        row = show(
            "lstm_cell", f"B={B} I={I} H={H}",
            lambda: lstm.lstm_cell_cuda(p, x, h, c),
            lambda: lstm.lstm_cell_reference(p, x, h, c),
            cell_bound(B, I, H, dt),
            lambda: torch.lstm_cell(x, (h, c_lib), w_ih, w_hh, b_ih, b_hh),
        )
        if B == 768:  # the beam-3 serving batch, 256 images x 3 beams
            rows["lstm_cell"] = row
    # Show-and-Tell's layer 0 (phase 12): the 512-wide image or word
    # embedding, at the later beam steps (768) and at greedy, the first beam
    # step and training (256)
    st_rows = {}
    for B in (768, 256):
        I, H = 512, 1024
        p, x, h, c = cell_inputs(B, I, H, dt, SEED)
        w_ih = p["w"][:I].t().contiguous()
        w_hh = p["w"][I:].t().contiguous()
        b_ih = p["b"].to(dt)
        b_hh = torch.zeros_like(b_ih)
        c_lib = c.to(dt)
        st_rows[f"B={B} I={I} H={H}"] = show(
            "lstm_cell", f"B={B} I={I} H={H}",
            lambda: lstm.lstm_cell_cuda(p, x, h, c),
            lambda: lstm.lstm_cell_reference(p, x, h, c),
            cell_bound(B, I, H, dt),
            lambda: torch.lstm_cell(x, (h, c_lib), w_ih, w_hh, b_ih, b_hh),
        )
    B, L, D = 256, 196, 512
    ce, f, hp, watt = attention_inputs(B, 1, L, D, dt, SEED + 1)
    hp1 = hp[:, 0].contiguous()
    rows["additive_attention"] = show(
        "additive_attention", f"B={B} K=1 L={L} D={D}",
        lambda: fa.fused_attention(ce, f, hp1, watt),
        lambda: fa.attention_reference(ce, f, hp1, watt),
        attention_bound(B, 1, L, D, dt),
    )
    # the first kernel, and for the per-row attention the cluster kernel at
    # K=1 (the baseline its one-pass design has to beat), then the plan's
    # again, each with its share of the bound
    def beside(name, others, planned, bound_ms):
        for label, fn in others:
            ms = time_cold(fn)
            print(f"    {label}: {ms:.4f} ms ({bound_ms / ms:.1%} of the bound)")
        cuda_lib.LAUNCHES.clear()
        ms = time_cold(planned)
        print(f"    {name} by the plan's {_design(name)}, again: {ms:.4f} ms ({bound_ms / ms:.1%} of the bound)")

    beside("additive_attention",
           [("additive_attention by direct (the first kernel)",
             lambda: fa.launch_attention("additive_attention", ce, f, hp, watt)),
            ("attention_beam at K=1 (cluster kernel, " + "-".join(map(str, fda.beam_plan(1, L, D, 2, True))) + ")",
             lambda: fda.attention_beam_cluster(ce, f, hp, watt))],
           lambda: fa.fused_attention(ce, f, hp1, watt), rows["additive_attention"]["bound_ms"])
    ce, f, hp, watt = attention_inputs(B, 3, L, D, dt, SEED + 1)
    shape = f"B={B} K=3 L={L} D={D}"
    rows["attention_beam"] = show(
        "attention_beam", shape,
        lambda: fda.attention_beam(ce, f, hp, watt),
        lambda: fda.attention_beam_reference(ce, f, hp, watt),
        attention_bound(B, 3, L, D, dt),
    )
    rows["attention_beam_grid2"] = show(
        "attention_beam_grid2", shape,
        lambda: fda.attention_beam(ce, f, hp, watt, variant="grid2"),
        lambda: fda.attention_beam_reference(ce, f, hp, watt),
        attention_bound(B, 3, L, D, dt),
    )
    beside("attention_beam_grid2",
           [("attention_beam_grid2 by direct (the first kernel)",
             lambda: fa.launch_attention("attention_beam_grid2", ce, f, hp, watt))],
           lambda: fda.attention_beam(ce, f, hp, watt, variant="grid2"), rows["attention_beam_grid2"]["bound_ms"])
    # the kernel on a ce^T made beforehand: a decode transposes the
    # step-invariant ce once; attention_beam(variant="st_*") pays the
    # transpose on every call, timed apart below
    cet = ce.transpose(1, 2).contiguous()
    rows["attention_beam_st"] = show(
        "attention_beam_st", shape,
        lambda: fda.attention_beam_st(cet, f, hp, watt),
        lambda: fda.attention_beam_st_reference(cet, f, hp, watt),
        attention_bound(B, 3, L, D, dt),
    )
    beside("attention_beam_st",
           [("attention_beam_st by direct (the first kernel)", lambda: fda.attention_beam_st_direct(cet, f, hp, watt))],
           lambda: fda.attention_beam_st(cet, f, hp, watt), rows["attention_beam_st"]["bound_ms"])
    # the cluster design at K=1: the same bytes and skeleton (scores, block
    # softmax, context, cluster merge) for a third of the tanh
    hp1 = hp[:, :1].contiguous()
    cuda_lib.LAUNCHES.clear()
    ms = time_cold(lambda: fda.attention_beam_st(cet, f, hp1, watt))
    print(f"    attention_beam_st at K=1 by {_design('attention_beam_st')}: {ms:.4f} ms "
          f"({attention_bound(B, 1, L, D, dt)[0] / ms:.1%} of its bound)")
    t_ms = time_cold(lambda: ce.transpose(1, 2).contiguous())
    t_bound = 2 * ce.numel() * ce.element_size() / PEAK_BYTES_PER_S * 1e3
    print(f"  {'ce transpose (plain)':19s} B={B} L={L} D={D}{'':8s} ms {t_ms:.4f}  bound_ms {t_bound:.4f} "
          f"(bytes): paid per call by attention_beam(variant='st_*')")
    rows["attention_scores"] = show(
        "attention_scores", shape,
        lambda: fda.attention_scores(ce, hp, watt, "s16"),
        lambda: fda.attention_scores_reference(ce, hp, watt),
        scores_bound(B, 3, L, D, dt),
    )
    beside("attention_scores",
           [("attention_scores by direct (the first kernel)", lambda: fda.attention_scores_direct(ce, hp, watt))],
           lambda: fda.attention_scores(ce, hp, watt, "s16"), rows["attention_scores"]["bound_ms"])

    # the probe: one line in the table by the default form, then every form
    # with its tanh per second beside the special-function rate assumed above
    rows["tanh_probe"] = show(
        "tanh_probe", shape,
        lambda: tp.tanh_probe(ce, hp),
        lambda: tp.tanh_probe_reference(ce, hp),
        probe_bound(B, 3, L, D, dt),
    )
    # K=3 is the serving shape; K=8 reads the same ce for 2.7 times the tanh,
    # which takes the memory out of the way of the tanh rate
    for dtype, K in ((dt, 3), (dt, 8), (torch.float32, 3), (torch.float32, 8)):
        g = _gen(SEED + 7)
        pce, php = _randn((B, L, D), g, dtype), _randn((B, K, D), g, dtype)
        n_tanh = B * K * L * D
        ce_ms = pce.numel() * pce.element_size() / PEAK_BYTES_PER_S * 1e3
        print(f"    tanh_probe {str(dtype).replace('torch.', '')} K={K}: {n_tanh / 1e6:.1f} M tanh, "
              f"ce's bytes at 3.35 TB/s {ce_ms:.4f} ms")
        for form in tp.TANH_FORMS:
            if form == "bf16x2" and dtype != torch.bfloat16:
                continue
            ms = time_cold(lambda: tp.tanh_probe(pce, php, form))
            clean = time_cold(lambda: tp.tanh_probe(pce, php, form), flush_by="read")
            per = SFU_PER_TANH[form]
            floor = (f"{n_tanh * per / PEAK_SFU_PER_S * 1e3:.4f} ms at {per:g} operations per tanh"
                     if per else "not counted")
            print(f"      {form:10s} {ms:.4f} ms = {n_tanh / ms / 1e9:.2f} T tanh/s, after a read flush "
                  f"{clean:.4f} ms = {n_tanh / clean / 1e9:.2f} T tanh/s  (special-function floor assumed: {floor})")
    # what the harness itself reads for a call that does next to nothing, and
    # for a plain read of the serving shape's ce (a sum over L: no tanh)
    tce, thp = _randn((1, 1, 8), _gen(SEED), dt), _randn((1, 1, 8), _gen(SEED), dt)
    print(f"    harness floor, a probe call on 8 elements: {time_cold(lambda: tp.tanh_probe(tce, thp)):.4f} ms")

    def read():
        return ce.sum(dim=1, dtype=torch.float32)

    print(f"    harness floor, a plain sum over L of ce ({ce.numel() * 2 / 1e6:.1f} MB): {time_cold(read):.4f} ms, "
          f"after a read flush {time_cold(read, flush_by='read'):.4f} ms")
    # the clocks while the card runs the probe back to back for ~0.5 s
    for _ in range(12000):
        tp.tanh_probe(ce, hp)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,clocks.mem,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.cuda.synchronize()
    print(f"    clocks under load (sm, max sm, mem, power draw): {clocks}")
    return rows, st_rows


def phase_probe():
    """The JAX attention benchmark's probe loop (``micro_tanh``) on the port:
    20 steps of the probe at the serving shape in bf16, each step's output
    nudging the next step's hp, as the benchmark chains its steps so that none
    can be dropped. Returns the probe's launches."""
    from show_and_tell_tpu_torch.ops import cuda_lib
    from show_and_tell_tpu_torch.ops import tanh_probe as tp

    B, K, L, D = 256, 3, 196, 512
    rng = np.random.default_rng(SEED)
    ce = torch.from_numpy(rng.standard_normal((B, L, D), dtype=np.float32)).cuda().bfloat16()
    hp0 = torch.from_numpy(rng.standard_normal((B, K, D), dtype=np.float32)).cuda().bfloat16()

    def loop():
        c, total = hp0, 0.0
        for _ in range(STEPS):
            o = tp.tanh_probe(ce, c)
            c = c + o[:, None, :].to(c.dtype) * 1e-3
            total = total + o.sum()
        return total, o

    loop()
    torch.cuda.synchronize()
    cuda_lib.LAUNCHES.clear()
    t0 = time.perf_counter()
    total, o = loop()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / STEPS * 1e3
    n = cuda_lib.LAUNCHES["tanh_probe"]
    print(f"  tanh probe loop: {STEPS} steps, {ms:.4f} ms/step (host clock), launches {n} "
          f"({_design('tanh_probe')}), sum {float(total):.1f}")
    assert n == STEPS, f"the probe loop launched the probe {n} times"
    assert o.shape == (B, D) and torch.isfinite(o).all() and np.isfinite(float(total))
    return {"tanh_probe": n}


def phase_end_to_end():
    from show_and_tell_tpu_torch.config import Config
    from show_and_tell_tpu_torch.data.transforms import eval_transform
    from show_and_tell_tpu_torch.decode.dispatch import decode_ids
    from show_and_tell_tpu_torch.models.registry import build_model
    from show_and_tell_tpu_torch.ops import cuda_lib
    from show_and_tell_tpu_torch.ops.fused_attention import attention_plan
    from show_and_tell_tpu_torch.serve import Captioner
    from show_and_tell_tpu_torch.utils.vocab import Vocabulary

    print("== 5. serving: Captioner at full width, bf16, 256 images")
    V, N = 10000, 256
    vocab = Vocabulary.from_words(f"w{i}" for i in range(V - 4))
    assert len(vocab) == V
    cfg = Config(dtype="bfloat16")
    print(
        f"  config: {cfg.model} {cfg.encoder} crop {cfg.crop_size} E={cfg.embed_size} "
        f"H={cfg.hidden_size} V={V} beam {cfg.beam_size} max_decode_len {cfg.max_decode_len} {cfg.dtype}"
    )
    model = build_model(cfg, V, device="cuda", generator=torch.Generator().manual_seed(SEED))
    cap = Captioner(cfg, model, None, vocab, device="cuda")
    images = np.random.default_rng(SEED).integers(0, 256, (N, 256, 256, 3), dtype=np.uint8)

    warm = cap.warmup(modes=("beam", "greedy"), buckets=(N,))
    print(f"  warmup (beam and greedy at bucket {N}): {warm:.2f} s")
    path_kernels = {"beam": ("lstm_cell", "attention_beam"), "greedy": ("lstm_cell", "additive_attention")}
    launches = {name: 0 for name in REPLACES}
    captions, img_s = {}, {}
    for mode, kernels in path_kernels.items():
        torch.cuda.synchronize()
        cuda_lib.LAUNCHES.clear()
        secs = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            caps = cap.caption_images(images, mode=mode)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        counts = {name: cuda_lib.LAUNCHES[name] for name in REPLACES}
        for name, n in counts.items():
            launches[name] += n
        dt = statistics.median(secs)
        img_s[mode] = N / dt
        print(f"  {mode:6s}: {N} images in {dt * 1e3:.2f} ms (median of {REPS}: "
              f"{', '.join(f'{s * 1e3:.2f}' for s in secs)}) = {N / dt:.1f} img/s  launches {counts}")
        print(f"  {mode:6s} caption[0]: {caps[0]!r}")
        assert len(caps) == N and all(isinstance(s, str) for s in caps)
        captions[mode] = caps
        missing = [k for k in kernels if counts[k] == 0]
        assert not missing, f"{mode}: kernels of the path never launched: {missing}"
        # random weights never emit <end>: every batch runs every step, one
        # launch of each kernel per step, the cell by its Hopper design
        per_batch = {k: counts[k] / REPS for k in kernels}
        designs = {k: cuda_lib.designs(k) for k in kernels}
        print(f"  {mode:6s} launches per batch {per_batch}, designs {designs}")
        assert all(n == cfg.max_decode_len for n in per_batch.values()), \
            f"{mode}: launches per batch {per_batch}, expected {cfg.max_decode_len} each"
        assert designs["lstm_cell"] == {"wgmma": REPS * cfg.max_decode_len}, designs
        if mode == "beam":  # the cluster kernel with f by bulk copy
            assert all(d.endswith("-f_bulk") for d in designs["attention_beam"]), designs
        else:  # the one-pass design, at the split the plan gives 196 patch rows of 512 bf16
            plan = attention_plan(N, 196, 512, 2, True)
            assert plan[0] == "onepass", plan
            assert designs["additive_attention"] == {f"onepass{plan[1]}": REPS * cfg.max_decode_len}, designs

    # where the time goes: trunk vs decode, host clock around synchronised work
    with torch.inference_mode():
        x = torch.from_numpy(images).cuda()
        for mode in ("beam", "greedy"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feats = model.backbone_features(eval_transform(x, cfg.crop_size))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ids = decode_ids(model, cfg, feats, mode)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            assert ids.shape == (N, cfg.max_decode_len)
            assert int(ids.min()) >= 0 and int(ids.max()) < V
            print(f"  {mode:6s} split: transform+trunk {(t1 - t0) * 1e3:.2f} ms, decode {(t2 - t1) * 1e3:.2f} ms")
            profile_window(lambda: decode_ids(model, cfg, feats, mode), mode)

    # the decode step through the kernels against the plain path: the same
    # weights (same seed) on the CPU, where every op runs its plain version,
    # fed the card's features, over 5 forced tokens
    cfg32 = cfg.replace(dtype="float32")
    m32 = build_model(cfg32, V, device="cuda", generator=torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED + 1)
    x8 = torch.from_numpy(images[:8]).cuda()
    with torch.inference_mode():
        for c, m in ((cfg32, m32), (cfg, model)):
            m_cpu = build_model(c, V, device="cpu", generator=torch.Generator().manual_seed(SEED))
            feats = m.backbone_features(eval_transform(x8, c.crop_size))
            assert feats.shape == (8, 196, 512) and torch.isfinite(feats).all()
            rtol = LOGITS_RTOL[m.cdtype]
            for k in (1, 3):
                toks = torch.from_numpy(rng.integers(0, V, (5, 8 * k)))
                sk, ck, _ = m.make_decode_state(feats, k)
                sp, cp, _ = m_cpu.make_decode_state(feats.cpu(), k)
                worst = 0.0
                for t in range(5):
                    ck, lk = sk(ck, toks[t].cuda())
                    cp, lp = sp(cp, toks[t])
                    assert lk.shape == (8 * k, V) and torch.isfinite(lk).all()
                    worst = max(worst, _diffs(lk.cpu(), lp)[1])
                print(f"  {c.dtype} step logits, kernels vs plain, k={k}: "
                      f"max|diff|/max|logit| {worst:.3e} (tol {rtol:g})")
                assert worst <= rtol, f"{c.dtype} k={k}: kernel path logits disagree with the plain path"
    return launches, model, cfg, images, captions, img_s


def phase_beam_routes(model, cfg, images):
    """The decode-step chain of the JAX package's attention benchmark
    (``full_chain``) on the port: per step the h-projection, the beam
    attention by one route, the cell and the head, the argmax feeding the
    next step's embedding. Returns each route kernel's launches."""
    from show_and_tell_tpu_torch.data.transforms import eval_transform
    from show_and_tell_tpu_torch.models.layers import dense, embedding_lookup
    from show_and_tell_tpu_torch.ops import cuda_lib, lstm
    from show_and_tell_tpu_torch.ops import fused_decode_attention as fda
    from show_and_tell_tpu_torch.utils.vocab import START_ID

    # route -> (its kernel, attention(ce, ce^T, f, hp, w_att))
    routes = {
        "s16_cmxu": ("attention_beam", lambda ce, cet, f, hp, w: fda.attention_beam(ce, f, hp, w, "s16_cmxu")),
        "grid2": ("attention_beam_grid2", lambda ce, cet, f, hp, w: fda.attention_beam(ce, f, hp, w, "grid2")),
        # ce is step-invariant: transposed once per decode, before the loop
        "st_cmxu": ("attention_beam_st", lambda ce, cet, f, hp, w: fda.attention_beam_st(cet, f, hp, w)),
        "hybrid-s16": ("attention_scores",
                       lambda ce, cet, f, hp, w: fda.attention_beam_hybrid(ce, f, hp, w, "s16")),
    }
    N, K = images.shape[0], 3
    print(f"== 6. beam-route decode chain: {N} images x {K} beams, {STEPS} steps, {cfg.dtype}, "
          "the serving model's weights")
    with torch.inference_mode():
        feats = model.backbone_features(eval_transform(torch.from_numpy(images).cuda(), cfg.crop_size))
        t, f, ce, h0, c0 = model.decode_init(feats)
        cet = ce.transpose(1, 2).contiguous()
        h0, c0 = h0.repeat_interleave(K, dim=0), c0.repeat_interleave(K, dim=0)
        D = f.shape[2]

        def chain(route, tokens=None):
            """20 steps; with ``tokens`` each step embeds tokens[s] (the
            default route's argmax) instead of its own, so that the routes'
            logits can be compared step by step. Returns (logits, argmaxes)."""
            attend = routes[route][1]
            h, c = h0, c0
            tok = torch.full((N * K,), START_ID, dtype=torch.long, device="cuda")
            logits_all, picks = [], []
            for s in range(STEPS):
                emb = embedding_lookup(t["embed"], tok)
                hp = (h @ t["att"]["w_hh"] + t["att"]["b_hh"]).reshape(N, K, D)
                ctx, _ = attend(ce, cet, f, hp, t["att"]["w_att"])
                ctx = ctx.reshape(N * K, D)
                h, c = lstm.lstm_cell(t["lstm"], torch.cat([emb, ctx], dim=-1), h, c)
                logits = dense(t["classifier"], dense(t["c2o"], ctx) + dense(t["h2o"], h))
                pick = logits.argmax(dim=-1)
                tok = pick if tokens is None else tokens[s]
                logits_all.append(logits)
                picks.append(pick)
            return logits_all, picks

        ref_logits, ref_tokens = chain("s16_cmxu")
        # the design each route's kernel must have launched 20 times, by its plan
        plans = {"hybrid-s16": fda.scores_plan(K, 196, D, 2, True)[:2],
                 "grid2": fda.grid2_plan(N, K, 196, D, 2, True)[:2],
                 "st_cmxu": fda.st_plan(K, 196, D, 2, True)}
        assert [p[0] for p in plans.values()] == ["stream", "onepass", "cluster"], plans
        launches = {}
        for route, (kernel, _) in routes.items():
            chain(route, ref_tokens)  # warm
            torch.cuda.synchronize()
            cuda_lib.LAUNCHES.clear()
            logits, _ = chain(route, ref_tokens)
            torch.cuda.synchronize()
            n, n_cell = cuda_lib.LAUNCHES[kernel], cuda_lib.LAUNCHES["lstm_cell"]
            kernel_designs = cuda_lib.designs(kernel)
            assert cuda_lib.designs("lstm_cell") == {"wgmma": STEPS}, cuda_lib.designs("lstm_cell")
            worst = max(_diffs(a, b)[1] for a, b in zip(logits, ref_logits))
            del logits
            # the host clock around a synchronised decode, and how much of it
            # had passed when the host had queued the last launch: where the
            # two agree the host sets the pace and the card waits for it
            secs, queued = [], []
            for _ in range(CHAIN_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                chain(route, ref_tokens)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                queued.append(t1 - t0)
            ms = statistics.median(secs) / STEPS * 1e3
            rtol = LOGITS_RTOL[model.cdtype]
            print(f"  {route:11s} {ms:.4f} ms/step (median of {CHAIN_REPS} decodes of {STEPS} steps, least "
                  f"{min(secs) / STEPS * 1e3:.4f}, most {max(secs) / STEPS * 1e3:.4f}; the host queueing "
                  f"{sum(queued) / sum(secs):.1%} of it)  launches {kernel} {n} {kernel_designs}, lstm_cell "
                  f"{n_cell}  step logits vs s16_cmxu max|diff|/max|logit| {worst:.3e} (tol {rtol:g})")
            assert n == STEPS and n_cell == STEPS, f"{route}: {kernel} launched {n} times, cell {n_cell}"
            if route in plans:  # the newer design, at the plan's split of 196 rows
                assert kernel_designs == {"".join(map(str, plans[route])): STEPS}, (route, kernel_designs)
            assert worst <= rtol, f"{route}: step logits disagree with the default route"
            launches[kernel] = n
            profile_window(lambda: chain(route, ref_tokens), route, top=5)
    return launches


@contextlib.contextmanager
def plain_ops():
    """Route the model's training-step calls to the plain versions (autograd
    through plain PyTorch on the card), to hold the kernel path against."""
    from show_and_tell_tpu_torch.models import show_attend_tell as sat
    from show_and_tell_tpu_torch.models import show_tell as st
    from show_and_tell_tpu_torch.ops import attention, lstm

    saved = sat.fused_additive_attention, sat.lstm_cell, st.lstm_cell
    sat.fused_additive_attention, sat.lstm_cell = attention.additive_attention, lstm.lstm_cell_reference
    st.lstm_cell = lstm.lstm_cell_reference
    try:
        yield
    finally:
        sat.fused_additive_attention, sat.lstm_cell, st.lstm_cell = saved


def phase_training(images):
    from show_and_tell_tpu_torch.config import Config
    from show_and_tell_tpu_torch.data.transforms import eval_transform
    from show_and_tell_tpu_torch.models.registry import build_model
    from show_and_tell_tpu_torch.ops import cuda_lib
    from show_and_tell_tpu_torch.ops.fused_attention import attention_plan
    from show_and_tell_tpu_torch.train.step import make_train_state, make_train_step
    from show_and_tell_tpu_torch.utils.vocab import START_ID

    V, T = 10000, 20
    N = images.shape[0]
    cfg = Config(dtype="bfloat16")
    print(f"== 7. training: full width (E={cfg.embed_size} H={cfg.hidden_size} V={V}), {cfg.dtype}, "
          f"batch {N}, T={T}, uint8 images {tuple(images.shape)}, lr {cfg.learning_rate}")
    model = build_model(cfg, V, device="cuda", generator=torch.Generator().manual_seed(SEED))
    state = make_train_state(cfg, model)
    step = make_train_step(model, cfg)
    rng = np.random.default_rng(SEED + 2)
    caps = np.concatenate([np.full((N, 1), START_ID), rng.integers(4, V, (N, T - 1))], 1)
    batch = {
        "images": torch.from_numpy(images).cuda(),
        "captions": torch.from_numpy(caps).cuda(),
        "lengths": torch.full((N,), T, device="cuda"),
    }
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    lr = cfg.learning_rate
    losses = []

    def one_step():
        nonlocal state
        state, m = step(state, batch, lr, generator=gen)
        losses.append(m["loss"])
        return m

    t0 = time.perf_counter()
    for _ in range(WARM_STEPS):
        one_step()
    torch.cuda.synchronize()
    print(f"  {WARM_STEPS} warm steps: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        m = one_step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    img_s = TIMED_STEPS * N / dt
    print(f"  {TIMED_STEPS} timed steps: {dt * 1e3 / TIMED_STEPS:.2f} ms/step = {img_s:.1f} img/s  "
          f"(grad_norm {float(m['grad_norm']):.4f}, tokens {float(m['tokens']):.0f})")

    # the split, host clock around synchronised work
    marks = []

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    mark()
    feats = step.features(batch, gen)
    mark()
    loss, _ = step.forward(feats, batch, generator=gen)
    mark()
    grads = step.backward(state, loss)
    mark()
    state, _ = step.apply(state, grads, lr)
    mark()
    losses.append(loss.detach())
    del grads
    split = dict(zip(("trunk", "forward", "backward", "optimizer"),
                     (1e3 * (b - a) for a, b in zip(marks, marks[1:]))))
    print("  split: " + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items()))

    torch.cuda.synchronize()
    cuda_lib.LAUNCHES.clear()
    one_step()
    torch.cuda.synchronize()
    counts = {k: cuda_lib.LAUNCHES[k] for k in ("lstm_cell", "additive_attention")}
    cell_designs = cuda_lib.designs("lstm_cell")
    attn_designs = cuda_lib.designs("additive_attention")
    print(f"  launches per step: {counts} (T-1 = {T - 1} each), cell designs {cell_designs}, "
          f"attention designs {attn_designs}")
    assert all(n == T - 1 for n in counts.values()), f"training launches {counts}, expected {T - 1} each"
    assert cell_designs == {"wgmma": T - 1}, f"training cell designs {cell_designs}"
    plan = attention_plan(N, 196, 512, 2, True)
    assert plan[0] == "onepass" and attn_designs == {f"onepass{plan[1]}": T - 1}, \
        f"training attention designs {attn_designs}"
    profile_window(one_step, "train step")

    losses = [float(x) for x in losses]
    print(f"  loss by step: {', '.join(f'{x:.4f}' for x in losses)}")
    assert all(np.isfinite(losses)), "a training loss is not finite"
    assert losses[-1] < losses[0], "the training loss did not fall"
    del step, feats, loss

    # one fp32 step: gradients through the kernels against the plain path
    cfg32 = cfg.replace(dtype="float32")
    m32 = build_model(cfg32, V, device="cuda", generator=torch.Generator().manual_seed(SEED))
    st32 = make_train_state(cfg32, m32)
    s32 = make_train_step(m32, cfg32)
    with torch.no_grad():
        f32 = m32.backbone_features(eval_transform(batch["images"], cfg.crop_size))
    b32 = dict(batch, features=f32)
    grads = {}
    for path in ("kernels", "plain"):
        cuda_lib.LAUNCHES.clear()
        with plain_ops() if path == "plain" else contextlib.nullcontext():
            loss, _ = s32.forward(f32, b32)
            grads[path] = s32.backward(st32, loss)
        torch.cuda.synchronize()
        n = cuda_lib.LAUNCHES["lstm_cell"] + cuda_lib.LAUNCHES["additive_attention"]
        print(f"  fp32 step, {path} path: loss {float(loss.detach()):.6f}, kernel launches {n}")
        assert n == (2 * (T - 1) if path == "kernels" else 0)
    rel = {k: _diffs(grads["kernels"][k], grads["plain"][k])[1] for k in grads["plain"]}
    worst = max(rel, key=rel.get)
    print(f"  fp32 gradients, kernels vs plain, max|diff|/max|grad| per parameter: worst {worst} "
          f"{rel[worst]:.3e} (limit {GRAD_RTOL:g}); " + ", ".join(f"{k} {v:.1e}" for k, v in rel.items()))
    assert rel[worst] <= GRAD_RTOL, "kernel-path gradients disagree with the plain path"
    return {"img_s": img_s, "ms_per_step": dt * 1e3 / TIMED_STEPS, "split_ms": split,
            "launches_per_step": counts, "losses": losses, "grad_rel_err": rel}, state, cfg


def _first_difference(got, want):
    return next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)


def _timed_calls(fn, kernels):
    """Median seconds of REPS synchronised calls of ``fn`` after one warm
    call, the last call's result, and the launches of ``kernels`` per call
    with their designs."""
    from show_and_tell_tpu_torch.ops import cuda_lib

    fn()
    torch.cuda.synchronize()
    cuda_lib.LAUNCHES.clear()
    secs = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    per_call = {k: cuda_lib.LAUNCHES[k] / REPS for k in kernels}
    designs = {k: {d: n / REPS for d, n in cuda_lib.designs(k).items()} for k in kernels}
    return statistics.median(secs), secs, out, per_call, designs


def phase_serving_rest(model, cfg, images, captions, train_state, train_cfg):
    """Checkpoints in and out, sampling, n-best and attention maps at full
    width on phase 5's images and weights. Returns the figures and, under
    ``launches``, the launches per kernel of the timed runs."""
    from show_and_tell_tpu_torch import ckpt
    from show_and_tell_tpu_torch.decode.greedy import greedy_decode
    from show_and_tell_tpu_torch.decode.sample import sample_decode
    from show_and_tell_tpu_torch.models.encoders import to_torch_vgg16
    from show_and_tell_tpu_torch.models.registry import build_model
    from show_and_tell_tpu_torch.ops import cuda_lib
    from show_and_tell_tpu_torch.ops.fused_attention import attention_plan
    from show_and_tell_tpu_torch.serve import Captioner
    from show_and_tell_tpu_torch.train.step import make_train_state
    from show_and_tell_tpu_torch.utils.vocab import Vocabulary

    N, V, T = images.shape[0], model.vocab_size, cfg.max_decode_len
    L = (cfg.crop_size // 16) ** 2  # the trunk's stride-16 patch grid: 196
    vocab = Vocabulary.from_words(f"w{i}" for i in range(V - 4))
    print(f"== 8. the rest of serving: checkpoints, sampling, n-best, attention maps; {N} images, {cfg.dtype}")
    out = {"launches": {name: 0 for name in REPLACES}}
    with tempfile.TemporaryDirectory() as tmp:
        # the serving model's decoder through model-best.pt, its trunk through
        # a torchvision-keyed file, back through from_checkpoint
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        best = ckpt.save_best(tmp, ckpt.trainable_state_dict(model), None, {"iter": 0})
        t_save = time.perf_counter() - t0
        trunk = os.path.join(tmp, "vgg16.pth")
        torch.save(to_torch_vgg16(model.encoder), trunk)
        cfg8 = cfg.replace(encoder_weights=trunk)
        t0 = time.perf_counter()
        cap = Captioner.from_checkpoint(cfg8, tmp, vocab)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        print(f"  save_best {t_save:.3f} s ({os.path.getsize(best) / 1e6:.1f} MB model-best.pt); "
              f"from_checkpoint {t_load:.3f} s (model init, model-best.pt, the {os.path.getsize(trunk) / 1e6:.1f} MB "
              f"trunk, onto the card)")
        out.update(save_best_s=t_save, from_checkpoint_s=t_load, model_best_bytes=os.path.getsize(best))
        sd, loaded = model.state_dict(), cap.model.state_dict()
        assert set(sd) == set(loaded) and all(torch.equal(sd[k], loaded[k]) for k in sd), "weights differ after the load"
        for mode in ("beam", "greedy"):
            got = cap.caption_images(images, mode=mode)
            if got != captions[mode]:
                i = _first_difference(got, captions[mode])
                print(f"  {mode}: image {i} differs: {got[i]!r} against phase 5's {captions[mode][i]!r}")
            assert got == captions[mode], f"{mode}: the restored Captioner's captions differ from phase 5's"
            print(f"  {mode:6s} captions of the restored Captioner: all {N} identical to phase 5's")

        # phase 7's train state through state-last.pt
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = ckpt.save_train_state(tmp, train_state)
        t_save = time.perf_counter() - t0
        fresh = build_model(train_cfg, V, device="cuda", generator=torch.Generator().manual_seed(SEED + 8))
        template = make_train_state(train_cfg, fresh)
        t0 = time.perf_counter()
        restored = ckpt.load_train_state(tmp, template)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        pairs = [(f"{part}/{k}", v, restored_part[k])
                 for part, saved_part, restored_part in (
                     ("params", train_state.params, restored.params),
                     ("mu", train_state.opt_state["mu"], restored.opt_state["mu"]),
                     ("nu", train_state.opt_state["nu"], restored.opt_state["nu"]))
                 for k, v in saved_part.items()]
        unequal = [name for name, a, b in pairs if not torch.equal(a, b)]
        print(f"  save_train_state {t_save:.3f} s ({os.path.getsize(path) / 1e6:.1f} MB state-last.pt), "
              f"load_train_state {t_load:.3f} s; {len(pairs)} tensors, {len(unequal)} unequal; count "
              f"{restored.opt_state['count']} (saved {train_state.opt_state['count']}), step {restored.step} "
              f"(saved {train_state.step})")
        assert not unequal, f"train state tensors differ after the load: {unequal[:5]}"
        assert restored.opt_state["count"] == train_state.opt_state["count"] and restored.step == train_state.step
        assert restored.ema_params is None and train_state.ema_params is None
        out.update(save_train_state_s=t_save, load_train_state_s=t_load, state_last_bytes=os.path.getsize(path))
        del fresh, template, restored

    cap.temperature, cap.top_k, cap.top_p = 1.0, 0, 0.9
    warm = cap.warmup(modes=("sample", "nbest", "attention"), buckets=(N,))
    assert cap._sample_count == 0
    print(f"  warmup (sample, nbest, attention at bucket {N}): {warm:.2f} s")
    plan = attention_plan(N, L, 512, 2, True)
    onepass = f"onepass{plan[1]}"
    samples = []

    def sample():
        samples.append(cap.caption_images(images, mode="sample"))
        return samples[-1]

    surfaces = {
        "sample": (sample, {"lstm_cell": "wgmma", "additive_attention": onepass}),
        "nbest": (lambda: cap.caption_nbest(images), {"lstm_cell": "wgmma", "attention_beam": None}),
        "attention": (lambda: cap.caption_with_attention(images),
                      {"lstm_cell": "wgmma", "additive_attention": onepass}),
    }
    results = {}
    for name, (fn, kernels) in surfaces.items():
        dt, secs, results[name], per_call, designs = _timed_calls(fn, kernels)
        print(f"  {name:9s}: {N} images in {dt * 1e3:.2f} ms (median of {REPS}: "
              f"{', '.join(f'{s * 1e3:.2f}' for s in secs)}) = {N / dt:.1f} img/s  launches per batch {per_call}, "
              f"designs {designs}")
        out[f"{name}_img_s"] = N / dt
        for k, design in kernels.items():
            out["launches"][k] += int(per_call[k] * REPS)
            assert per_call[k] == T, f"{name}: {k} launched {per_call[k]} times per batch, expected {T}"
            if design is not None:
                assert designs[k] == {design: T}, f"{name}: {k} designs {designs[k]}, expected {design}"
            else:  # the cluster kernel with f by bulk copy
                assert all(d.endswith("-f_bulk") for d in designs[k]), f"{name}: {k} designs {designs[k]}"

    # sampling: the timed calls drew other streams each, a fresh Captioner
    # of the same seed replays the first
    print(f"  sample caption[0]: {samples[1][0]!r}")
    differ = sum(a != b for a, b in zip(samples[1], samples[2]))
    replay = Captioner(cfg8, cap.model, None, vocab)
    replay.temperature, replay.top_k, replay.top_p = cap.temperature, cap.top_k, cap.top_p
    again = replay.caption_images(images, mode="sample")
    print(f"  sample: two calls differ on {differ} of {N} images; a fresh Captioner replays the first call: "
          f"{again == samples[0]}")
    assert differ > 0 and again == samples[0], "sampling streams"
    assert all(len(c.split()) <= T for c in samples[0])

    # top-k 1: greedy, but for ties. The filter keeps every token tied with
    # the top logit and draws among them, so in bf16 a draw may leave
    # greedy's path, and only at a tie. The Captioner's draw is replayed with
    # each step's logits recorded: every drawn token's logit is its step's
    # largest, the same prefix gives the same logits in both runs, and where
    # a caption first leaves greedy's the two tokens' logits are equal.
    cap.top_k, cap.top_p = 1, 1.0
    base = cap._sample_count
    k1 = cap.caption_images(images, mode="sample")
    same = sum(a == b for a, b in zip(k1, captions["greedy"]))

    def recording(step_fn, seen):
        def step(carry, prev):
            carry, logits = step_fn(carry, prev)
            seen.append(logits.float())
            return carry, logits
        return step

    with torch.inference_mode():
        feats = cap._features(images)
        g_seen, s_seen = [], []
        step_fn, carry, first, _ = cap.model.decode_state(feats, beam_size=1)
        g_ids = greedy_decode(recording(step_fn, g_seen), carry, N, T, first_logits=first, early_stop=False)
        step_fn, carry, first, _ = cap.model.decode_state(feats, beam_size=1)
        gen = cap._keys.generator("sample", base, device=cap.device)
        s_ids = sample_decode(recording(step_fn, s_seen), carry, N, gen, T, top_k=1, first_logits=first)
        G, S = torch.stack(g_seen, 1), torch.stack(s_seen, 1)  # [N, T, V] fp32
        del feats, g_seen, s_seen
        top = S.amax(-1)
        drawn_is_top = torch.equal(S.gather(-1, s_ids[..., None]).squeeze(-1), top)
        tied_steps = int(((S == top[..., None]).sum(-1) > 1).sum())
        off_argmax = int((s_ids != S.argmax(-1)).sum())
        # prefix[b, t]: the two runs fed the same tokens before step t
        prefix = torch.cat([torch.ones(N, 1, dtype=torch.bool, device=S.device),
                            (s_ids == g_ids)[:, :-1].long().cumprod(1).bool()], 1)
        same_logits = torch.equal(G[prefix], S[prefix])
        left = (s_ids != g_ids).any(1)
        rows = left.nonzero().squeeze(1)
        t0 = (s_ids != g_ids).int().argmax(1)[rows]
        tie_at_exit = torch.equal(S[rows, t0].gather(-1, g_ids[rows, t0][:, None]),
                                  S[rows, t0].gather(-1, s_ids[rows, t0][:, None]))
        replayed = cap.vocab.decode_batch(s_ids.cpu().numpy()) == k1
        greedy_again = cap.vocab.decode_batch(g_ids.cpu().numpy()) == captions["greedy"]
        del G, S
    print(f"  sample top_k=1, {cfg.dtype}: {same} of {N} captions equal greedy's; replayed with the logits "
          f"recorded (equal to the Captioner's: {replayed}, greedy's: {greedy_again}): {tied_steps} of {N * T} "
          f"steps tie at the top, {off_argmax} draws took a tied token other than the first; every draw a top "
          f"logit: {drawn_is_top}; same prefix, same logits: {same_logits}; {int(left.sum())} captions leave "
          f"greedy's, each at a tie: {tie_at_exit}")
    assert replayed and greedy_again, "the replay with recorded logits differs from the Captioner's"
    assert drawn_is_top and same_logits and tie_at_exit, "top_k=1 sampling left the top logits in bf16"
    assert int(left.sum()) >= N - same
    out.update(top1_equal_greedy=same, top1_tied_steps=tied_steps, top1_off_argmax=off_argmax)
    cap32 = Captioner(cfg8.replace(dtype="float32"),
                      build_model(cfg8.replace(dtype="float32"), V, device="cuda"), cap.model.state_dict(), vocab)
    cap32.top_k = 1
    greedy32 = cap32.caption_images(images, mode="greedy")
    k1_32 = cap32.caption_images(images, mode="sample")
    if k1_32 != greedy32:
        i = _first_difference(k1_32, greedy32)
        print(f"  float32: image {i} differs: {k1_32[i]!r} against greedy's {greedy32[i]!r}")
    print(f"  sample top_k=1, float32: all {N} captions equal greedy's: {k1_32 == greedy32}")
    assert k1_32 == greedy32, "top_k=1 sampling differs from greedy in fp32"
    del cap32

    # n-best: the best of each list is the beam caption, scores best first
    nbest = results["nbest"]
    assert len(nbest) == N and all(len(row) == cfg.beam_size for row in nbest)
    firsts = [row[0][0] for row in nbest]
    if firsts != captions["beam"]:
        i = _first_difference(firsts, captions["beam"])
        print(f"  nbest: image {i}: {firsts[i]!r} against the beam caption {captions['beam'][i]!r}")
    assert firsts == captions["beam"], "nbest[i][0] differs from the beam caption"
    scores = np.array([[s for _, s in row] for row in nbest])
    assert np.isfinite(scores).all() and (np.diff(scores, axis=1) <= 0).all(), "n-best scores increase"
    print(f"  nbest: [0] equals the beam caption for all {N} images; scores {scores[0].round(4).tolist()} "
          f"(image 0), not increasing")

    # attention maps
    caps, alphas = results["attention"]
    worst = float(np.abs(alphas.sum(-1) - 1).max())
    print(f"  attention: alphas {alphas.shape} {alphas.dtype}, max |row sum - 1| {worst:.2e} (limit 1e-3), "
          f"captions equal greedy's: {caps == captions['greedy']}")
    assert alphas.shape == (N, T, L) and alphas.dtype == np.float32 and np.isfinite(alphas).all()
    assert worst <= 1e-3, "attention rows do not sum to 1"
    assert caps == captions["greedy"], "caption_with_attention's captions differ from greedy's"
    return out


# --- phase 9: the eval driver on a trained decoder --------------------------

# the JAX package's benchmark scenes (bench.py), kept here: 18 classes (6
# colours x 3 shapes) on a noisy grey ground, 5 caption templates per class
SCENE_RGB = {
    "red": (200, 30, 30), "green": (30, 200, 30), "blue": (30, 30, 200),
    "yellow": (220, 220, 30), "purple": (160, 30, 200), "white": (230, 230, 230),
}
SCENE_SHAPES = ("circle", "square", "triangle")
SCENES = 256  # training images, and as many held-out images
EVAL_BATCH = 64  # held-out images per batch of the eval driver
TRAIN_STEPS, TRAIN_LR = 200, 3e-3  # bench.py's in-bench training of the decoder
COCOID0 = 500_000  # the held-out images' ids in the annotation file
# fp32 greedy ids, kernels vs plain: where they differ, the plain path's two
# top logits must lie closer than this at the first differing step
TIE_GAP = 1e-4


def scene_templates(color: str, shape: str):
    return [
        ["a", color, shape, "sitting", "on", "a", "wooden", "table", "near", "a", "window"],
        ["there", "is", "a", color, shape, "on", "a", "wooden", "table"],
        ["a", "large", color, shape, "resting", "on", "a", "table", "near", "a", "window"],
        ["a", "photo", "of", "a", color, shape, "on", "a", "table"],
        ["a", color, shape, "on", "a", "table", "in", "a", "bright", "room"],
    ]


def render_scenes(rng, n: int):
    """(uint8 images [n, 256, 256, 3], class ids): a coloured shape at a
    jittered place on a noisy grey ground, class i % 18."""
    classes = [(c, s) for c in SCENE_RGB for s in SCENE_SHAPES]
    yy, xx = np.ogrid[:96, :96]
    masks = {
        "circle": (yy - 47.5) ** 2 + (xx - 47.5) ** 2 <= 47.5 ** 2,
        "square": np.ones((96, 96), bool),
        "triangle": (xx >= 47.5 - yy / 2.0) & (xx <= 47.5 + yy / 2.0),
    }
    arr = np.empty((n, 256, 256, 3), np.uint8)
    cls = np.arange(n) % len(classes)
    for i in range(n):
        color, shape = classes[cls[i]]
        img = rng.normal(125, 14, (256, 256, 3)).astype(np.float32)
        y0 = 80 + int(rng.integers(-24, 25))
        x0 = 80 + int(rng.integers(-24, 25))
        img[y0:y0 + 96, x0:x0 + 96][masks[shape]] = np.array(SCENE_RGB[color], np.float32)
        arr[i] = np.clip(img, 0, 255).astype(np.uint8)
    return arr, cls


def _same_scores(a, b) -> bool:
    """Exact equality through dicts and lists; NaN equals NaN (SPICE's
    undefined subcategories)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same_scores(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_scores(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and np.isnan(a):
        return isinstance(b, float) and np.isnan(b)
    return a == b


def _coco_eval(predictions, ann_file, python: bool):
    """(corpus, per image) scores of ``predictions``, the C++ scorers forced
    off with ``python``."""
    from show_and_tell_tpu_torch.metrics import bleu, cider, meteor, rouge
    from show_and_tell_tpu_torch.metrics.coco import COCO
    from show_and_tell_tpu_torch.metrics.orchestrator import COCOEvalCap

    mods = (bleu, cider, meteor, rouge)
    saved = [m._cpp_available for m in mods]
    if python:
        for m in mods:
            m._cpp_available = lambda: False
    try:
        coco = COCO(ann_file)
        res = coco.loadRes(predictions)
        ev = COCOEvalCap(coco, res)
        ev.params["image_id"] = res.getImgIds()
        ev.evaluate()
    finally:
        for m, probe in zip(mods, saved):
            m._cpp_available = probe
    return ev.eval, ev.imgToEval


def phase_eval(cfg):
    """The port's eval driver over the JAX benchmark's scenes, before and
    after 200 training steps of the decoder. Returns the figures, and the
    trained decoder with its scenes and references (for phase 13)."""
    from show_and_tell_tpu_torch.data.transforms import eval_transform
    from show_and_tell_tpu_torch.decode.dispatch import decode_ids
    from show_and_tell_tpu_torch.evalsuite import driver
    from show_and_tell_tpu_torch.models.registry import build_model
    from show_and_tell_tpu_torch.ops import cuda_lib
    from show_and_tell_tpu_torch.train.step import make_train_state, make_train_step
    from show_and_tell_tpu_torch.utils import native
    from show_and_tell_tpu_torch.utils.vocab import START_ID, Vocabulary

    V, T = 10000, cfg.max_decode_len
    rows = ("lstm_cell", "additive_attention", "attention_beam")
    print(f"== 9. eval driver on a trained decoder: {cfg.model} {cfg.encoder} crop {cfg.crop_size} "
          f"E={cfg.embed_size} H={cfg.hidden_size} V={V} {cfg.dtype}, beam {cfg.beam_size}, max_decode_len {T}; "
          f"{SCENES} training and {SCENES} held-out scenes, batches of {EVAL_BATCH}")
    t_phase = time.perf_counter()
    status = native.status()
    print(f"  native scorers: {status}")
    assert status == {s: "native" for s in native.SCORERS}, f"a native scorer is not live: {status}"

    # the scenes, their vocabulary (real words in the low ids, filler up to V)
    classes = [(c, s) for c in SCENE_RGB for s in SCENE_SHAPES]
    real = list(dict.fromkeys(w for c, s in classes for t in scene_templates(c, s) for w in t))
    vocab = Vocabulary.from_words(real + [f"w{i}" for i in range(V - 4 - len(real))])
    assert len(vocab) == V
    rng = np.random.default_rng(SEED)
    train_images, train_cls = render_scenes(rng, SCENES)
    eval_images, eval_cls = render_scenes(rng, SCENES)
    # one template per training image; the held-out images are scored against all five
    tokens = [scene_templates(*classes[k])[(i // len(classes)) % 5] for i, k in enumerate(train_cls)]
    captions, lengths = vocab.encode_batch(tokens, T)
    eval_tokens = [scene_templates(*classes[k])[(i // len(classes)) % 5] for i, k in enumerate(eval_cls)]
    eval_captions, eval_lengths = vocab.encode_batch(eval_tokens, T)
    refs = [[" ".join(t) for t in scene_templates(*classes[k])] for k in eval_cls]
    batches = [
        {"images": eval_images[i:i + EVAL_BATCH], "captions": eval_captions[i:i + EVAL_BATCH],
         "lengths": eval_lengths[i:i + EVAL_BATCH], "imgids": list(range(i, i + EVAL_BATCH)),
         "cocoids": [COCOID0 + j for j in range(i, i + EVAL_BATCH)]}
        for i in range(0, SCENES, EVAL_BATCH)
    ]
    loss_launches = T - 1  # rows 1 and 2 per batch in the teacher-forced loss

    model = build_model(cfg, V, device="cuda", generator=torch.Generator().manual_seed(SEED))
    out = {"native": status, "decoders": {}}
    with tempfile.TemporaryDirectory() as tmp:
        ann_file = os.path.join(tmp, "captions_heldout.json")
        with open(ann_file, "w") as fh:
            json.dump({
                "images": [{"id": COCOID0 + i} for i in range(SCENES)],
                "annotations": [{"image_id": COCOID0 + i, "id": 5 * i + r, "caption": c}
                                for i in range(SCENES) for r, c in enumerate(refs[i])],
            }, fh)

        def evaluate(decoder):
            """Both modes through ``driver.evaluation``; prints and returns
            the figures, and the predictions by mode."""
            figures, preds = {}, {}
            for mode in ("beam", "greedy"):
                # warm: the trunk and decode at this batch, no metrics
                driver.evaluation(model, cfg, batches[:1], vocab, mode=mode, run_language_eval=False)
                marks, le_secs = [], []

                def marked():
                    for b in batches:
                        marks.append(dict(cuda_lib.LAUNCHES))
                        yield b
                    marks.append(dict(cuda_lib.LAUNCHES))

                def timed_language_eval(*a):
                    t0 = time.perf_counter()
                    try:
                        return saved(*a)
                    finally:
                        le_secs.append(time.perf_counter() - t0)

                torch.cuda.synchronize()
                cuda_lib.LAUNCHES.clear()
                saved, driver.language_eval = driver.language_eval, timed_language_eval
                try:
                    t0 = time.perf_counter()
                    loss, predictions, stats = driver.evaluation(model, cfg, marked(), vocab, mode=mode,
                                                                 ann_file=ann_file)
                    torch.cuda.synchronize()
                    secs = time.perf_counter() - t0
                finally:
                    driver.language_eval = saved
                launches = {k: cuda_lib.LAUNCHES[k] for k in rows}
                per_batch = [{k: b.get(k, 0) - a.get(k, 0) for k in rows} for a, b in zip(marks, marks[1:])]
                if mode == "beam":
                    steps = [d["attention_beam"] for d in per_batch]
                else:
                    steps = [d["additive_attention"] - loss_launches for d in per_batch]
                assert all(d["lstm_cell"] == loss_launches + s for d, s in zip(per_batch, steps)), per_batch
                by_id = {p["image_id"]: p["caption"] for p in predictions}
                caps = [by_id[COCOID0 + i] for i in range(SCENES)]
                exact = sum(c in refs[i] for i, c in enumerate(caps)) / SCENES
                mean_len = float(np.mean([len(c.split()) for c in caps]))
                print(f"  {decoder:9s} {mode:6s}: val loss {loss:.4f}; " + ", ".join(
                    f"{k} {v:.4f}" for k, v in stats.items()))
                print(f"  {decoder:9s} {mode:6s}: exact captions {exact:.4f}, mean length {mean_len:.2f} words, "
                      f"decode steps per batch {steps}; {SCENES} images in {secs:.3f} s = {SCENES / secs:.1f} img/s "
                      f"(language_eval {le_secs[0]:.3f} s of it; without it {SCENES / (secs - le_secs[0]):.1f} "
                      f"img/s); launches {launches}")
                print(f"  {decoder:9s} {mode:6s} caption[0]: {caps[0]!r}")
                assert len(predictions) == SCENES and np.isfinite(loss), "every held-out image once, a finite loss"
                assert set(stats) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr", "SPICE"}
                path = ("lstm_cell", "attention_beam") if mode == "beam" else ("lstm_cell", "additive_attention")
                assert all(launches[k] > 0 for k in path), f"{decoder} {mode}: kernels of the path {launches}"
                figures[mode] = {"val_loss": loss, "lang_stats": stats, "exact": exact, "mean_len": mean_len,
                                 "steps_per_batch": steps, "eval_s": secs, "img_s": SCENES / secs,
                                 "language_eval_s": le_secs[0], "launches": launches}
                preds[mode] = predictions
            return figures, preds

        out["decoders"]["untrained"], _ = evaluate("untrained")

        # train the decoder on the training scenes' trunk features, computed once
        with torch.no_grad():
            feats = torch.cat([
                model.backbone_features(eval_transform(torch.from_numpy(train_images[i:i + EVAL_BATCH]).cuda(),
                                                       cfg.crop_size))
                for i in range(0, SCENES, EVAL_BATCH)])
        batch = {"features": feats, "captions": torch.from_numpy(captions).cuda(),
                 "lengths": torch.from_numpy(lengths).cuda()}
        state = make_train_state(cfg, model)
        step = make_train_step(model, cfg)
        torch.cuda.synchronize()
        cuda_lib.LAUNCHES.clear()
        t0 = time.perf_counter()
        losses = []
        for _ in range(TRAIN_STEPS):
            state, m = step(state, batch, TRAIN_LR)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        losses = [float(x) for x in losses]
        train_launches = {k: cuda_lib.LAUNCHES[k] for k in rows}
        print(f"  training: {TRAIN_STEPS} steps at lr {TRAIN_LR:g} on {SCENES} scenes' features in {train_s:.2f} s; "
              f"loss at step 1 {losses[0]:.4f}, at step {TRAIN_STEPS} {losses[-1]:.4f}; launches {train_launches}")
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], "the training loss did not fall"
        out["training"] = {"steps": TRAIN_STEPS, "lr": TRAIN_LR, "seconds": train_s, "loss_first": losses[0],
                           "loss_last": losses[-1], "launches": train_launches}
        del feats, batch, state, step

        out["decoders"]["trained"], preds = evaluate("trained")
        untrained, trained = out["decoders"]["untrained"], out["decoders"]["trained"]
        for mode in ("beam", "greedy"):
            t, u = trained[mode], untrained[mode]
            assert t["mean_len"] < T, f"trained {mode}: mean caption length {t['mean_len']}"
            assert min(t["steps_per_batch"]) < T, f"trained {mode}: no batch stopped early {t['steps_per_batch']}"
            cider_t, cider_u = t["lang_stats"]["CIDEr"], u["lang_stats"]["CIDEr"]
            assert cider_t >= max(10 * cider_u, 1.0), f"{mode}: CIDEr {cider_t} trained, {cider_u} untrained"

            # the native scorers against the pure-Python path, per image
            t0 = time.perf_counter()
            corpus_n, per_n = _coco_eval(preds[mode], ann_file, python=False)
            t_native = time.perf_counter() - t0
            t0 = time.perf_counter()
            corpus_p, per_p = _coco_eval(preds[mode], ann_file, python=True)
            t_python = time.perf_counter() - t0
            same = _same_scores(per_n, per_p) and _same_scores(corpus_n, corpus_p)
            print(f"  trained   {mode:6s}: the native scorers against the pure-Python path on its {len(per_n)} "
                  f"captions: every metric per image and corpus equal: {same} (suite {t_native:.3f} s native, "
                  f"{t_python:.3f} s Python)")
            assert same, f"{mode}: native and Python scores differ"
            assert _same_scores(corpus_n, t["lang_stats"]), "the driver's language_eval differs from COCOEvalCap's"

    # fp32: the trained decoder's greedy ids through the kernels against the
    # plain path, on the card
    cfg32 = cfg.replace(dtype="float32")
    m32 = build_model(cfg32, V, device="cuda", generator=torch.Generator().manual_seed(SEED))
    m32.load_state_dict(model.state_dict())
    del model
    with torch.no_grad():
        f32 = torch.cat([
            m32.backbone_features(eval_transform(torch.from_numpy(eval_images[i:i + EVAL_BATCH]).cuda(),
                                                 cfg.crop_size))
            for i in range(0, SCENES, EVAL_BATCH)])
        ids = {}
        for path in ("kernels", "plain"):
            cuda_lib.LAUNCHES.clear()
            with plain_ops() if path == "plain" else contextlib.nullcontext():
                ids[path] = decode_ids(m32, cfg32, f32, "greedy")
            torch.cuda.synchronize()
            n = sum(cuda_lib.LAUNCHES[k] for k in rows)
            assert (n > 0) == (path == "kernels"), f"fp32 {path} path: {n} kernel launches"
        differ = (ids["kernels"] != ids["plain"]).any(1).nonzero().squeeze(1).tolist()
        gaps = []
        for r in differ:  # the plain path's two top logits at the first differing step
            t_diff = int((ids["kernels"][r] != ids["plain"][r]).int().argmax())
            with plain_ops():
                step_fn, carry, _, _ = m32.decode_state(f32[r:r + 1], beam_size=1)
                prev = torch.full((1,), START_ID, dtype=torch.long, device="cuda")
                for s in range(t_diff + 1):
                    carry, logits = step_fn(carry, prev)
                    prev = ids["plain"][r:r + 1, s]
            top2 = logits[0].float().topk(2).values
            gaps.append(float(top2[0] - top2[1]))
            print(f"  fp32 greedy: image {r} differs at step {t_diff}: kernels {ids['kernels'][r].tolist()}, "
                  f"plain {ids['plain'][r].tolist()}; the plain top-two logit gap there {gaps[-1]:.3e}")
    print(f"  fp32 greedy ids of the trained decoder, kernels vs plain: {SCENES - len(differ)} of {SCENES} "
          f"identical; differences at top-two gaps under {TIE_GAP:g}: {all(g < TIE_GAP for g in gaps)}")
    assert all(g < TIE_GAP for g in gaps), f"fp32 greedy ids differ away from a tie: gaps {gaps}"
    out["fp32_greedy_differ"] = len(differ)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 9: {out['seconds']:.1f} s")
    # the trained decoder and its scenes, which phase 13 serves on the int8 trunk
    decoder = {"cfg": cfg, "vocab": vocab, "state": {k: v.detach().clone() for k, v in m32.state_dict().items()},
               "train_images": train_images, "eval_images": eval_images, "refs": refs}
    return out, decoder


# --- phase 10: the training CLI on the card ---------------------------------

V_TRAIN = 10000  # the vocabulary phase 10 reaches through build_vocab
FILLER_PER_SENTENCE = 20  # filler words per test-split caption
TRAIN_CLI_EPOCHS = 40  # of 5 steps at batch 256: 200 steps, as phase 9 trains
TRAIN_CLI_GATE = 50  # steps between the gates: 4 gate evaluations
RESUME_AT = 7  # the resume run is triggered while step RESUME_AT + 1's batch is made
FEATURE_STEPS = 10  # cli.main steps fed by the extracted features


class _Watched:
    """A loader wrapper that forwards ``set_epoch`` and ``set_resume_skip``,
    records the captions of each batch it hands out and the skips it was
    asked for, and triggers ``guard`` while making its batch ``at`` (0-based,
    over epochs): with the trainer's one-batch lookahead, after step ``at``."""

    def __init__(self, loader, guard=None, at=-1):
        self.loader, self.guard, self.at = loader, guard, at
        self.captions, self.skips = [], []

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def set_resume_skip(self, n):
        self.skips.append(n)
        self.loader.set_resume_skip(n)

    def __iter__(self):
        for b in self.loader:
            if len(self.captions) == self.at:
                self.guard.trigger()
            self.captions.append(b["captions"])
            yield b


@contextlib.contextmanager
def _timed_transfers(seconds):
    """Record the host seconds of each ``Trainer._to_device`` (the pinned
    copy of a batch and its queued copy to the card)."""
    from show_and_tell_tpu_torch.train.trainer import Trainer

    to_device = Trainer._to_device

    def timed(self, batch):
        t0 = time.perf_counter()
        out = to_device(self, batch)
        seconds.append(time.perf_counter() - t0)
        return out

    Trainer._to_device = timed
    try:
        yield
    finally:
        Trainer._to_device = to_device


@contextlib.contextmanager
def _recording_steps(steps):
    """Record, per call of ``TrainStep``, the batch's array shapes, the
    launches of rows 1 and 2 during the step and its host seconds (the step
    waits on its gradient norm, so that is its device time but the tail of
    the optimizer's launches)."""
    from show_and_tell_tpu_torch.ops import cuda_lib
    from show_and_tell_tpu_torch.train import step as step_mod

    rows = ("lstm_cell", "additive_attention")
    call = step_mod.TrainStep.__call__

    def recorded(self, state, batch, *a, **kw):
        before = {k: cuda_lib.LAUNCHES[k] for k in rows}
        t0 = time.perf_counter()
        out = call(self, state, batch, *a, **kw)
        steps.append({"shapes": {k: tuple(v.shape) for k, v in batch.items()},
                      "launches": {k: cuda_lib.LAUNCHES[k] - before[k] for k in rows},
                      "loss": out[1]["loss"], "seconds": time.perf_counter() - t0})
        return out

    step_mod.TrainStep.__call__ = recorded
    try:
        yield
    finally:
        step_mod.TrainStep.__call__ = call


@contextlib.contextmanager
def _timed_evaluations(gates):
    """Record the seconds and the launches of each ``evaluation`` call (the
    trainer's gate calls it through ``make_trainer_eval_fn``)."""
    from show_and_tell_tpu_torch.evalsuite import driver
    from show_and_tell_tpu_torch.ops import cuda_lib

    evaluation = driver.evaluation

    def timed(*a, **kw):
        before = dict(cuda_lib.LAUNCHES)
        t0 = time.perf_counter()
        out = evaluation(*a, **kw)
        torch.cuda.synchronize()
        gates.append({"seconds": time.perf_counter() - t0,
                      "launches": {k: cuda_lib.LAUNCHES[k] - before.get(k, 0) for k in REPLACES
                                   if cuda_lib.LAUNCHES[k] - before.get(k, 0)}})
        return out

    driver.evaluation = timed
    try:
        yield
    finally:
        driver.evaluation = evaluation


def _write_scene_corpus(tmp, rng):
    """The phase's corpus under ``tmp``: a Karpathy-format caption JSON
    (train: SCENES scenes with their class's 5 templates; val: SCENES
    held-out scenes, one template each, and a COCO annotation file of all
    5; test: filler captions that bring the vocabulary to V_TRAIN), and the
    train and val scenes' pixels as memmap shards keyed by the file paths
    that ``preprocess`` assigns. Returns the paths and the val references."""
    from show_and_tell_tpu_torch.data import memmap

    classes = [(c, s) for c in SCENE_RGB for s in SCENE_SHAPES]
    train_images, train_cls = render_scenes(rng, SCENES)
    val_images, val_cls = render_scenes(rng, SCENES)
    real = list(dict.fromkeys(w for c, s in classes for t in scene_templates(c, s) for w in t))
    filler = [f"w{i}" for i in range(V_TRAIN - 4 - len(real))]
    images, keys, refs = [], [], {}
    for split, cls in (("train", train_cls), ("val", val_cls)):
        for i, k in enumerate(cls):
            templates = scene_templates(*classes[k])
            sents = templates if split == "train" else [templates[(i // len(classes)) % 5]]
            imgid = len(images)
            cocoid = COCOID0 + imgid
            images.append({"split": split, "imgid": imgid, "cocoid": cocoid, "filepath": split,
                           "filename": f"scene{i}.png", "sentences": [{"tokens": t} for t in sents],
                           "sentids": [5 * imgid + j for j in range(len(sents))]})
            # the record's file_path: preprocess's data_root/filepath/filename
            keys.append(os.path.join("data", split, f"scene{i}.png"))
            if split == "val":
                refs[cocoid] = [" ".join(t) for t in templates]
    for j in range(0, len(filler), FILLER_PER_SENTENCE):
        imgid = len(images)
        images.append({"split": "test", "imgid": imgid, "cocoid": COCOID0 + imgid, "filepath": "test",
                       "filename": f"filler{j}.png", "sentences": [{"tokens": filler[j:j + FILLER_PER_SENTENCE]}],
                       "sentids": [5 * imgid]})
    paths = {"captions": os.path.join(tmp, "captions.json"), "ann": os.path.join(tmp, "captions_val.json"),
             "memmap": os.path.join(tmp, "memmap"), "vocab": os.path.join(tmp, "vocab.json"),
             "data": os.path.join(tmp, "data.json")}
    with open(paths["captions"], "w") as fh:
        json.dump({"images": images}, fh)
    with open(paths["ann"], "w") as fh:
        json.dump({"images": [{"id": c} for c in refs],
                   "annotations": [{"image_id": c, "id": 5 * c + r, "caption": t}
                                   for c, ts in refs.items() for r, t in enumerate(ts)]}, fh)
    # the documented shard layout (data/memmap.py), written without a codec
    os.makedirs(paths["memmap"])
    pixels = np.concatenate([train_images, val_images])
    pixels.tofile(os.path.join(paths["memmap"], "shard_00000.u8"))
    with open(os.path.join(paths["memmap"], memmap.INDEX), "w") as fh:
        json.dump({"image_size": 256, "items_per_shard": 8192, "shards": ["shard_00000.u8"],
                   "paths": {k: i for i, k in enumerate(keys)}}, fh)
    return paths, refs, dict(zip(keys, pixels))


def phase_train_cli(smi, bare_img_s, tmp):
    """The training user's path on the card: ``cli.preprocess`` ->
    memmap shards -> the loader -> ``cli.main`` (200 steps, CIDEr gates) ->
    a preempted and resumed ``Trainer`` -> ``cli.evaluate`` ->
    ``cli.extract_features`` -> ``cli.main`` on the features, its files under
    ``tmp``. Returns the figures, and what phase 11 serves: the flags, the
    best checkpoint's experiment dir and the scenes' pixels by key."""
    from show_and_tell_tpu_torch.ckpt.torch_import import load_encoder_weights
    from show_and_tell_tpu_torch.cli import evaluate as cli_evaluate
    from show_and_tell_tpu_torch.cli import extract_features as cli_extract
    from show_and_tell_tpu_torch.cli import main as cli_main
    from show_and_tell_tpu_torch.cli import preprocess as cli_preprocess
    from show_and_tell_tpu_torch.config import parse_config
    from show_and_tell_tpu_torch.data import memmap
    from show_and_tell_tpu_torch.data.dataset import CocoCaptionDataset
    from show_and_tell_tpu_torch.data.pipeline import make_loader
    from show_and_tell_tpu_torch.data.transforms import eval_transform
    from show_and_tell_tpu_torch.models.encoders import init_vgg16, to_torch_vgg16
    from show_and_tell_tpu_torch.models.registry import build_model
    from show_and_tell_tpu_torch.ops import cuda_lib
    from show_and_tell_tpu_torch.ops.fused_attention import attention_plan
    from show_and_tell_tpu_torch.train.preempt import PreemptionGuard
    from show_and_tell_tpu_torch.train.trainer import Trainer
    from show_and_tell_tpu_torch.utils import native
    from show_and_tell_tpu_torch.utils.rng import KeyChain
    from show_and_tell_tpu_torch.utils.vocab import Vocabulary

    print(f"== 10. the training CLI on the card: preprocess, memmap shards, cli.main, resume, cli.evaluate, "
          f"cli.extract_features; VGG16 at 224 px, E=512, H=1024, bf16, batch 256  [{smi}]")
    t_phase = time.perf_counter()
    out = {"card": smi}
    built = os.path.exists(native.lib_path("libimage_loader.so"))
    print(f"  libimage_loader.so built on this host (phase 2): {built}")
    out["image_loader_built"] = built
    paths, refs, pixels = _write_scene_corpus(tmp, np.random.default_rng(SEED + 10))
    index = os.path.join(paths["memmap"], memmap.INDEX)
    stamp = os.stat(index).st_mtime_ns
    memmap.pack_memmap(list(pixels), paths["memmap"], size=256)
    assert os.stat(index).st_mtime_ns == stamp, "pack_memmap did not reuse the complete shards"

    # 3. the vocabulary and the records through the real preprocess
    cli_preprocess.main(["--caption_json", paths["captions"], "--vocab_path", paths["vocab"],
                         "--output_json", paths["data"], "--word_count_threshold", "1",
                         "--print_stats", "false"])
    vocab = Vocabulary.load(paths["vocab"])
    records = json.load(open(paths["data"]))
    n_train = sum(r["split"] == "train" for r in records)
    print(f"  cli.preprocess: vocabulary {len(vocab)} words, {n_train} train records, "
          f"{sum(r['split'] == 'val' for r in records)} val records")
    assert len(vocab) == V_TRAIN and n_train == 5 * SCENES, (len(vocab), n_train)
    assert all(r["file_path"] in pixels for r in records if r["split"] != "test")

    trunk = os.path.join(tmp, "vgg16.pth")
    torch.save(to_torch_vgg16(init_vgg16(torch.Generator().manual_seed(SEED))), trunk)
    flags = ["--data_json", paths["data"], "--vocab_path", paths["vocab"], "--memmap_dir", paths["memmap"],
             "--encoder_weights", trunk, "--batch_size", "256", "--dtype", "bfloat16",
             "--ann_file", paths["ann"], "--learning_rate", str(TRAIN_LR), "--learning_rate_decay_start", "-1",
             "--scheduled_sampling_start", "-1", "--log_step", "5", "--language_eval", "1"]
    cfg = parse_config(flags + ["--max_epochs", str(TRAIN_CLI_EPOCHS),
                                "--save_checkpoint_every", str(TRAIN_CLI_GATE),
                                "--expr_dir", os.path.join(tmp, "exp")])

    # 4. the loader alone: one epoch from the shards
    train_ds = CocoCaptionDataset(records, vocab, "train", cfg.max_caption_len, cfg.num_buckets)
    loader = make_loader(cfg, train_ds, mode="train")
    t0 = time.perf_counter()
    batches = [(b["images"].shape, b["captions"].shape) for b in loader]
    secs = time.perf_counter() - t0
    n = sum(s[0][0] for s in batches)
    print(f"  loader alone: one epoch of {len(batches)} batches {sorted(set(batches))} from the memmap in "
          f"{secs:.3f} s = {n / secs:.1f} img/s on the host, corrupt_skipped {loader.corrupt_skipped}  [{smi}]")
    assert loader.corrupt_skipped == 0 and len(batches) == 5
    out["loader_img_s"] = n / secs

    # 5. cli.main: 200 steps with the CIDEr gate every 50
    steps, gates, lines, transfers = [], [], [], []
    handler = _LogLines(lines)
    tlog = logging.getLogger("show_and_tell_tpu_torch.train.trainer")
    tlog.addHandler(handler)
    tlog.setLevel(logging.INFO)
    torch.cuda.synchronize()
    cuda_lib.LAUNCHES.clear()
    try:
        with _recording_steps(steps), _timed_evaluations(gates), _timed_transfers(transfers):
            t0 = time.perf_counter()
            trainer = cli_main.main(cfg)
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t0
    finally:
        tlog.removeHandler(handler)
    expr_dir = trainer.cfg.expr_dir
    infos = json.load(open(os.path.join(expr_dir, "infos.json")))
    best = json.load(open(os.path.join(expr_dir, "infos-best.json")))
    for ln in lines:
        print(f"  cli.main log: epoch {ln[0]}, step {ln[1]}: loss {ln[2]:.4f}, {ln[3]:.1f} img/s, "
              f"{ln[4]:.0f} ms/step")
    ciders = {int(k): v["lang_stats"]["CIDEr"] for k, v in infos["val_result_history"].items()}
    for (it, c), g in zip(sorted(ciders.items()), gates):
        print(f"  gate at step {it}: CIDEr {c:.4f}, val loss {infos['val_result_history'][str(it)]['loss']:.4f}, "
              f"evaluation {g['seconds']:.3f} s, launches {g['launches']}  [{smi}]")
    img_s, ms = trainer.throughput.items_per_sec, 1e3 * trainer.timer.avg_s
    print(f"  cli.main: {len(steps)} steps in {main_s:.1f} s with the gates; the trainer's meters "
          f"{img_s:.1f} img/s, {ms:.1f} ms/step, against phase 7's {bare_img_s:.1f} img/s of bare steps "
          f"on one fixed batch  [{smi}]")
    # where a step of the loop goes, host clock: the meters' windows
    # exclude the gates
    loop_ms = 1e3 * trainer.throughput.seconds / (trainer.throughput.items / cfg.batch_size)
    call_ms = 1e3 * statistics.mean(s["seconds"] for s in steps)
    copy_ms = 1e3 * statistics.mean(transfers)
    print(f"  per step of the loop {loop_ms:.1f} ms: the TrainStep call {call_ms:.1f} ms (it waits on its gradient "
          f"norm), the batch to the card {copy_ms:.1f} ms (pinned copy, queued transfer), the rest "
          f"{loop_ms - call_ms - copy_ms:.1f} ms (the loader's queue, logging, the generator)  [{smi}]")
    per_step = [(s["shapes"]["captions"][1] - 1, s["launches"]) for s in steps]
    bad = [(want, got) for want, got in per_step if got != {"lstm_cell": want, "additive_attention": want}]
    cell_d, attn_d = cuda_lib.designs("lstm_cell"), cuda_lib.designs("additive_attention")
    print(f"  launches of rows 1 and 2 per step: pad_len - 1 on {len(steps) - len(bad)} of {len(steps)} steps "
          f"(pad_len - 1 in {sorted({w for w, _ in per_step})}); over the run, with the gates: "
          f"cell {cell_d}, attention {attn_d}")
    assert len(steps) == TRAIN_CLI_EPOCHS * 5 and not bad, bad[:3]
    plan = attention_plan(cfg.batch_size, 196, 512, 2, True)
    assert set(cell_d) == {"wgmma"} and set(attn_d) == {f"onepass{plan[1]}"}, (cell_d, attn_d)
    losses = [float(s["loss"]) for s in steps]
    log_losses = [ln[2] for ln in lines]
    assert all(np.isfinite(losses)) and log_losses[-1] < log_losses[0], "the loss did not fall"
    assert (infos["total_iter"], infos["epoch"]) == (TRAIN_CLI_EPOCHS * 5, TRAIN_CLI_EPOCHS), infos["total_iter"]
    best_it = max(ciders, key=ciders.get)
    print(f"  best: CIDEr {infos['best_val_score']:.4f} at step {best['total_iter']} "
          f"(the gates' largest: {ciders[best_it]:.4f} at step {best_it}); corrupt_skipped train "
          f"{trainer.trainloader.corrupt_skipped}, val {trainer.validloader.corrupt_skipped}")
    assert len(ciders) == 4 and infos["best_val_score"] == ciders[best_it] and best["total_iter"] == best_it
    assert ciders[best_it] >= 1.0, f"best CIDEr {ciders[best_it]}"
    assert trainer.trainloader.corrupt_skipped == 0 and trainer.validloader.corrupt_skipped == 0
    out["main"] = {"seconds": main_s, "img_s": img_s, "ms_per_step": ms, "bare_step_img_s": bare_img_s,
                   "loop_ms": loop_ms, "step_call_ms": call_ms, "to_device_ms": copy_ms,
                   "gates": [dict(g, step=it, cider=c) for (it, c), g in zip(sorted(ciders.items()), gates)],
                   "log_losses": log_losses, "best_step": best_it, "best_cider": ciders[best_it],
                   "launches": {"lstm_cell": cell_d, "additive_attention": attn_d}}
    del trainer

    # 6. preempt mid-epoch 2, then resume through start_from
    rcfg = cfg.replace(max_epochs=2, save_checkpoint_every=1000, expr_dir=os.path.join(tmp, "resume"))
    os.makedirs(rcfg.expr_dir)

    def resume_trainer(c, loader):
        model = build_model(c, len(vocab), device="cuda", generator=KeyChain(c.random_seed).generator("init"))
        return Trainer(c, model, loader)

    guard = PreemptionGuard()
    first = _Watched(make_loader(rcfg, train_ds), guard, at=RESUME_AT)
    infos = resume_trainer(rcfg, first).train(guard)
    print(f"  preempted: total_iter {infos['total_iter']}, epoch {infos['epoch']}, iter {infos['iter']}, "
          f"preempted {infos.get('preempted')}; state-last.pt "
          f"{os.path.getsize(os.path.join(rcfg.expr_dir, 'state-last.pt')) / 1e6:.1f} MB")
    assert infos.get("preempted") is True and (infos["total_iter"], infos["epoch"], infos["iter"]) == (7, 2, 2)
    second = _Watched(make_loader(rcfg, train_ds))
    infos = resume_trainer(rcfg.replace(start_from=rcfg.expr_dir), second).train(PreemptionGuard())
    plain = make_loader(rcfg, train_ds)
    plain.set_epoch(2)
    order = [b["captions"] for b in plain]
    same = np.array_equal(second.captions[0], order[2])
    print(f"  resumed: skips {second.skips}, {len(second.captions)} batches taken, the first equal to the "
          f"uninterrupted order's batch 3 of epoch 2: {same}; total_iter {infos['total_iter']}, "
          f"epoch {infos['epoch']}, preempted {infos.get('preempted')}")
    assert second.skips == [2] and len(second.captions) == 3 and same
    assert (infos["total_iter"], infos["epoch"]) == (10, 2) and not infos.get("preempted")

    # 7. cli.evaluate on the best checkpoint: greedy equals the gate, beam 3
    val_ds = CocoCaptionDataset(records, vocab, "val", cfg.max_caption_len, cfg.num_buckets)
    loss_launches = sum(p["pad_len"] - 1 for p in val_ds.iter_index_batches(256, shuffle=False))
    gate = json.load(open(os.path.join(expr_dir, "infos.json")))["val_result_history"][str(best_it)]
    out["evaluate"] = {}
    for beam in (1, 3):
        torch.cuda.synchronize()
        cuda_lib.LAUNCHES.clear()
        t0 = time.perf_counter()
        loss, preds, stats = cli_evaluate.main(flags + ["--load_model_path", expr_dir, "--beam_size", str(beam)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: cuda_lib.LAUNCHES[k] for k in ("lstm_cell", "additive_attention", "attention_beam")}
        print(f"  cli.evaluate beam {beam}: val loss {loss:.4f}, CIDEr {stats['CIDEr']:.4f}, "
              f"{len(preds)} images in {secs:.2f} s = {len(preds) / secs:.1f} img/s (model build, checkpoint "
              f"and the whole evaluation), launches {launches}  [{smi}]")
        if beam == 1:
            held = _same_scores(stats, gate["lang_stats"]) and preds[:10] == gate["predictions_sample"]
            print(f"  greedy lang_stats and first 10 predictions equal the gate's at step {best_it}: {held}")
            assert held, (stats, gate["lang_stats"])
            assert launches["additive_attention"] == launches["lstm_cell"] > loss_launches
            assert launches["attention_beam"] == 0
        else:
            steps_b = launches["lstm_cell"] - loss_launches
            assert launches["attention_beam"] == steps_b > 0 and launches["additive_attention"] == loss_launches
        out["evaluate"][f"beam{beam}"] = {"val_loss": loss, "lang_stats": stats, "img_s": len(preds) / secs,
                                           "launches": launches}

    # 8. cli.extract_features over the shards, then cli.main on the features
    npz = os.path.join(tmp, "features.npz")
    t0 = time.perf_counter()
    path = cli_extract.main(flags + ["--output_json", npz])
    ext_s = time.perf_counter() - t0
    feats = np.load(path)
    model = build_model(cfg, len(vocab), device="cuda", generator=KeyChain(cfg.random_seed).generator("init"))
    load_encoder_weights(cfg, model)
    ids = [r["cocoid"] for r in records if r["split"] != "test"]
    keys = [r["file_path"] for r in records if r["split"] != "test"]
    uniq = dict(zip(ids, keys))
    worst = scale = 0.0
    with torch.no_grad():
        items = list(uniq.items())
        for lo in range(0, len(items), 256):
            chunk = items[lo:lo + 256]
            x = torch.from_numpy(np.stack([pixels[k] for _, k in chunk])).cuda()
            want = model.backbone_features(eval_transform(x, cfg.crop_size)).float().cpu().numpy()
            got = np.stack([feats[str(c)] for c, _ in chunk])
            worst = max(worst, float(np.abs(got - want).max()))
            scale = max(scale, float(np.abs(want).max()))
    print(f"  cli.extract_features: {len(feats.files)} images in {ext_s:.2f} s = {len(feats.files) / ext_s:.1f} "
          f"img/s (model build, trunk, .npz written compressed); against backbone_features(eval_transform(x)) "
          f"max|diff| {worst:.3e} of scale {scale:.3f} = {worst / scale:.2e} (tol {RTOL[torch.bfloat16]:g})  "
          f"[{smi}]")
    assert len(feats.files) == len(uniq) == 2 * SCENES and worst <= RTOL[torch.bfloat16] * scale
    del model
    fsteps = []
    fcfg = parse_config(flags + ["--features_path", path, "--max_epochs", str(FEATURE_STEPS // 5),
                                 "--save_checkpoint_every", "1000", "--expr_dir", os.path.join(tmp, "feat")])
    with _recording_steps(fsteps):
        t0 = time.perf_counter()
        trainer = cli_main.main(fcfg)
        torch.cuda.synchronize()
        fsecs = time.perf_counter() - t0
    shapes = {tuple(sorted(s["shapes"].items())) for s in fsteps}
    flosses = [float(s["loss"]) for s in fsteps]
    print(f"  cli.main on the features: {len(fsteps)} steps in {fsecs:.2f} s with the model build, the "
          f"trainer's meters {trainer.throughput.items_per_sec:.1f} img/s; batch shapes {sorted(shapes)}; "
          f"loss {flosses[0]:.4f} -> {flosses[-1]:.4f}  [{smi}]")
    assert len(fsteps) == FEATURE_STEPS and all(np.isfinite(flosses))
    assert all(s["shapes"]["features"] == (256, 196, 512) and "images" not in s["shapes"] for s in fsteps)
    out["extract"] = {"seconds": ext_s, "img_s": len(feats.files) / ext_s, "rel_err": worst / scale,
                      "feature_steps_img_s": trainer.throughput.items_per_sec}
    del trainer, feats
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 10: {out['seconds']:.1f} s")
    return out, {"flags": flags, "expr_dir": expr_dir, "vocab": paths["vocab"], "pixels": pixels}


# --- phase 11: serving over HTTP, and the last CLIs, on the card -------------

HTTP_LEVELS = (1, 8, 32, 128)  # closed-loop clients, each posting batch-1 /caption requests
HTTP_BATCH = 256  # images in the one /caption_batch request
BURST, BURST_QUEUE = 64, 2  # concurrent requests against a server whose queue holds 2
NBEST_PROBES = 4  # ?nbest=1 requests
CHAIN_EPOCHS = 2  # cli.train_chain children, one epoch of phase 10's corpus (5 steps) each


def http_load(port, path, blob_path, offsets_path, concurrency, out_path):
    """Closed-loop load, run in a process of its own: its source is handed to
    ``python -c``, so it imports the standard library only. ``concurrency``
    threads POST ``path`` on 127.0.0.1:``port``, request i with body i
    (``blob_path``'s bytes at the (start, end) pairs of ``offsets_path``),
    one connection per request as urllib makes them; each thread posts its
    next request when its last one is answered. Writes {"seconds": wall,
    "requests": [[i, status, latency s, body], ...]} to ``out_path``; a
    connection that fails (reset, refused) is status 0."""
    import http.client
    import json
    import threading
    import time

    with open(blob_path, "rb") as fh:
        blob = fh.read()
    with open(offsets_path) as fh:
        offsets = json.load(fh)
    lock = threading.Lock()
    pending = list(range(len(offsets)))[::-1]
    done = []

    def client():
        while True:
            with lock:
                if not pending:
                    return
                i = pending.pop()
            a, b = offsets[i]
            t0 = time.perf_counter()
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
                conn.request("POST", path, body=blob[a:b], headers={"Connection": "close"})
                r = conn.getresponse()
                status, raw = r.status, r.read()
                conn.close()
            except OSError as e:
                status, raw = 0, repr(e).encode()
            latency = time.perf_counter() - t0
            with lock:
                done.append([i, status, latency, raw.decode()])

    threads = [threading.Thread(target=client) for _ in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    with open(out_path, "w") as fh:
        json.dump({"seconds": time.perf_counter() - t0, "requests": done}, fh)


def _run_load(tmp, port, path, blob_path, offsets, concurrency):
    """``http_load`` in a child process; returns what it wrote."""
    offsets_path, out_path = os.path.join(tmp, "offsets.json"), os.path.join(tmp, "load.json")
    with open(offsets_path, "w") as fh:
        json.dump(offsets, fh)
    src = inspect.getsource(http_load) + (
        f"\nhttp_load({port}, {path!r}, {blob_path!r}, {offsets_path!r}, {concurrency}, {out_path!r})\n")
    subprocess.run([sys.executable, "-c", src], check=True, timeout=600)
    with open(out_path) as fh:
        return json.load(fh)


def _http(port, path, data=None):
    """(status, body) of one request (POST with ``data``, else GET): the JSON
    body, or the text of /metrics."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("GET" if data is None else "POST", path, body=data)
        r = conn.getresponse()
        status, raw, ctype = r.status, r.read(), r.getheader("Content-Type")
    finally:
        conn.close()
    return status, (json.loads(raw) if ctype == "application/json" else raw.decode())


@contextlib.contextmanager
def _serving(srv):
    """Serve ``srv`` from a thread; yields its port, then shuts it down and
    closes it (and its batcher)."""
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield srv.server_address[1]
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)


def _decode_npy(data: bytes, size: int = 256):
    """Phase 11's stand-in for ``cli.serve_http._decode_image`` on a host
    with no image codec: the ``.npy`` bytes of one [size, size, 3] uint8
    image, or None."""
    try:
        img = np.load(io.BytesIO(data), allow_pickle=False)
    except (ValueError, OSError, EOFError):
        return None
    return img if img.shape == (size, size, 3) and img.dtype == np.uint8 else None


def _marked(images):
    """A copy with each image's index in pixel (0, 0), outside the 224 px
    centre crop that the model sees, so that a batch tells which images it
    holds."""
    out = images.copy()
    out[:, 0, 0, 0], out[:, 0, 0, 1] = np.divmod(np.arange(len(images)), 256)
    return out


def _marks(images):
    return (images[:, 0, 0, 0].astype(np.int64) * 256 + images[:, 0, 0, 1]).tolist()


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def _metric_values(text):
    return {k: float(v) for k, v in (ln.rsplit(" ", 1) for ln in text.splitlines() if ln and not ln.startswith("#"))}


def phase_http(smi, trained, tmp, direct_img_s):
    """The serving user's HTTP front door over phase 10's best checkpoint
    (``trained``: its flags, experiment dir, vocabulary and scenes), then
    ``cli.export_torch`` and ``cli.train_chain``, files under ``tmp``;
    ``direct_img_s`` is phase 5's img/s by mode. Returns the figures."""
    from show_and_tell_tpu_torch.cli import caption, export_torch, serve_http, train_chain
    from show_and_tell_tpu_torch.config import parse_config
    from show_and_tell_tpu_torch.ops import cuda_lib
    from show_and_tell_tpu_torch.serve import ERROR_CAPTION, Captioner
    from show_and_tell_tpu_torch.utils.vocab import Vocabulary

    print(f"== 11. serving over HTTP (cli.serve_http.make_server, its DynamicBatcher) from phase 10's best "
          f"checkpoint, cli.export_torch, cli.train_chain; VGG16 at 224 px, E=512, H=1024, V=10000, bf16  [{smi}]")
    t_phase = time.perf_counter()
    out = {"card": smi}
    try:
        from PIL import Image
    except ImportError:
        Image = None
    real_decode = serve_http._decode_image
    if Image is None:
        print("  decode: this host has no PIL (no image codec): for this phase serve_http._decode_image is bound to a "
              "stand-in that reads .npy bytes of one [256, 256, 3] uint8 image; restored after it")
        print("  cli.caption reads image files through PIL: not run here; held on the CPU (tests/test_torch_port_cli.py)")
        print("  POST /caption?attention=1 renders its sheet through PIL: not run here; held on the CPU "
              "(tests/test_torch_port_http.py)")
        serve_http._decode_image = _decode_npy

        def encode(img):
            buf = io.BytesIO()
            np.save(buf, img)
            return buf.getvalue()
    else:
        print("  decode: PIL is importable on this host: the requests carry PNG bytes through the real "
              "_decode_image, and cli.caption and ?attention=1 run")

        def encode(img):
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="PNG")
            return buf.getvalue()
    out["decode"] = "npy stand-in" if Image is None else "PIL"
    # the seconds of every request's decode, on the handler threads
    decode_s = []
    inner_decode = serve_http._decode_image

    def timed_decode(data, size=256):
        t0 = time.perf_counter()
        img = inner_decode(data, size)
        decode_s.append(time.perf_counter() - t0)
        return img

    serve_http._decode_image = timed_decode
    servers = []
    try:
        cfg = parse_config(trained["flags"] + ["--load_model_path", trained["expr_dir"]])
        vocab = Vocabulary.load(trained["vocab"])
        images = _marked(np.stack(list(trained["pixels"].values())))
        n = len(images)
        blob = bytearray()
        offsets = []
        for img in images:
            data = encode(img)
            offsets.append((len(blob), len(blob) + len(data)))
            blob += data
        blob_path = os.path.join(tmp, "bodies.bin")
        with open(blob_path, "wb") as fh:
            fh.write(blob)
        decoded = np.stack([serve_http._decode_image(bytes(blob[a:b])) for a, b in offsets])
        assert np.array_equal(decoded, images), "the request bodies do not decode to the images"

        # 1. the server a user starts: from the checkpoint, warmed over every bucket
        records = _Records()
        slog = logging.getLogger("show_and_tell_tpu_torch.cli.serve_http")
        slog.addHandler(records)
        try:
            t0 = time.perf_counter()
            srv0 = serve_http.make_server(cfg, vocab, "127.0.0.1", 0, warmup=True, warmup_surfaces="greedy")
            make_s = time.perf_counter() - t0
        finally:
            slog.removeHandler(records)
        servers.append(srv0)
        cap = srv0.batcher.captioner
        warm = [r.args[0] for r in records.records if r.msg.startswith("warmup done")]
        print(f"  make_server(--load_model_path {os.path.basename(trained['expr_dir'])}, --encoder_weights, warmup of "
              f"beam and greedy at buckets {cap.bucket_sizes}): {make_s:.2f} s, of which warmup {warm[0]:.1f} s")
        out["make_server_s"], out["warmup_s"] = make_s, warm[0]

        call = cap.caption_images
        batches = []

        def recorded(imgs, mode="beam", rng_offset=0):
            # the batcher's worker is the one thread that captions while a
            # server runs, so the counters' change is this batch's
            before = dict(cuda_lib.LAUNCHES)
            t0 = time.perf_counter()
            caps = call(imgs, mode=mode, rng_offset=rng_offset)
            batches.append({"mode": mode, "bucket": cap._bucket(len(imgs)), "ids": _marks(imgs), "captions": caps,
                            "seconds": time.perf_counter() - t0,
                            "launches": {k: v - before.get(k, 0) for k, v in cuda_lib.LAUNCHES.items()
                                         if v != before.get(k, 0)}})
            return caps

        cap.caption_images = recorded
        rows = []  # (mode, image id, bucket, caption) of every caption served

        def served(mode, answers):
            """The batches' rows, each answer equal to its image's row."""
            got = {}
            for b in batches:
                assert b["mode"] == mode, (b["mode"], mode)
                for i, c in zip(b["ids"], b["captions"]):
                    assert i not in got, f"image {i} captioned twice"
                    got[i] = (b["bucket"], c)
                    rows.append((mode, i, b["bucket"], c))
            assert sorted(got) == sorted(answers), "the batches do not hold the answered requests"
            bad = [i for i, c in answers.items() if c != got[i][1] or c == ERROR_CAPTION]
            assert not bad, f"answers differ from their batches' captions at images {bad[:5]}"

        def per_batch(mode):
            """Launches per batch: the cell and the mode's attention once per
            decode step, nothing else. Returns ({bucket: [steps]},
            {bucket: designs})."""
            att = "attention_beam" if mode == "beam" else "additive_attention"
            steps, designs = {}, {}
            for b in batches:
                base = {k: v for k, v in b["launches"].items() if "/" not in k}
                s = base.get("lstm_cell", 0)
                assert set(base) == {"lstm_cell", att} and base[att] == s and 1 <= s <= cfg.max_decode_len, \
                    (mode, b["bucket"], base)
                steps.setdefault(b["bucket"], []).append(s)
                d = designs.setdefault(b["bucket"], {})
                for k, v in b["launches"].items():
                    if "/" in k:
                        d[k] = d.get(k, 0) + v
            return steps, designs

        # 2. closed-loop load: each level and mode on a fresh server over the
        # same Captioner, so that the batcher's stats are that run's
        out["levels"] = {}
        for mode in ("beam", "greedy"):
            for c in HTTP_LEVELS:
                srv = serve_http.make_server(cfg, vocab, "127.0.0.1", 0, captioner=cap)
                servers.append(srv)
                del batches[:], decode_s[:]
                with _serving(srv) as port:
                    res = _run_load(tmp, port, "/caption" + ("" if mode == "beam" else "?mode=greedy"), blob_path,
                                    offsets, c)
                    stats = srv.batcher.stats()
                codes = {r[1] for r in res["requests"]}
                assert codes == {200} and len(res["requests"]) == n, \
                    f"{mode} at {c} clients: status codes {codes}, e.g. {[r[3] for r in res['requests'] if r[1] != 200][:2]}"
                answers = {r[0]: json.loads(r[3]) for r in res["requests"]}
                assert all(a["mode"] == mode for a in answers.values())
                served(mode, {i: a["caption"] for i, a in answers.items()})
                steps, designs = per_batch(mode)
                lat = np.percentile(np.array([r[2] for r in res["requests"]]) * 1e3, [50, 95, 99])
                img_s = n / res["seconds"]
                assert stats["requests"] == stats["batch_size_sum"] == n and stats["errors"] == 0, stats
                by_bucket = {b: len(s) for b, s in sorted(steps.items())}
                print(f"  {mode:6s} {c:3d} clients: {n} requests in {res['seconds']:.2f} s = {img_s:.1f} img/s; client "
                      f"p50/p95/p99 {lat[0]:.1f}/{lat[1]:.1f}/{lat[2]:.1f} ms; batcher {stats['batches']} batches, mean "
                      f"{stats['mean_batch_size']}, queue wait {stats['mean_queue_wait_ms']} ms, its p50/p95/p99 "
                      f"{stats['latency_ms']['p50']}/{stats['latency_ms']['p95']}/{stats['latency_ms']['p99']} ms; "
                      f"batches per bucket {by_bucket}  [{smi}]")
                busy = sum(b["seconds"] for b in batches)
                print(f"  {mode:6s} {c:3d} clients: the worker in caption_images {busy:.2f} s = "
                      f"{busy / res['seconds']:.1%} of the run ({busy / len(batches) * 1e3:.2f} ms per batch); the "
                      f"handlers' image decode {statistics.mean(decode_s) * 1e3:.2f} ms per request, "
                      f"{sum(decode_s):.2f} s in all  [{smi}]")
                print(f"  {mode:6s} {c:3d} clients: decode steps per batch by bucket "
                      f"{ {b: (min(s), round(statistics.mean(s), 1), max(s)) for b, s in sorted(steps.items())} } "
                      f"(min, mean, max); launches by design {designs}")
                out["levels"][f"{mode}@{c}"] = {
                    "seconds": res["seconds"], "img_s": img_s, "p50_ms": lat[0], "p95_ms": lat[1], "p99_ms": lat[2],
                    "batcher": stats, "batches_per_bucket": by_bucket, "worker_busy_s": busy,
                    "decode_ms": statistics.mean(decode_s) * 1e3,
                    "steps_per_batch": {b: s for b, s in steps.items()}, "designs": designs}

        # 3. one /caption_batch of 256, the health and metrics endpoints, n-best
        with _serving(srv0) as port:
            body = json.dumps([base64.b64encode(bytes(blob[a:b])).decode() for a, b in offsets[:HTTP_BATCH]]).encode()
            del batches[:]
            t0 = time.perf_counter()
            status, answer = _http(port, "/caption_batch", body)
            batch_s = time.perf_counter() - t0
            assert status == 200 and answer["errors"] == [] and len(answer["captions"]) == HTTP_BATCH, status
            served("beam", dict(enumerate(answer["captions"])))
            steps, designs = per_batch("beam")
            print(f"  POST /caption_batch of {HTTP_BATCH} ({len(body) / 1e6:.1f} MB of base64): {batch_s:.3f} s = "
                  f"{HTTP_BATCH / batch_s:.1f} img/s; batches {[len(b['ids']) for b in batches]} at buckets "
                  f"{[b['bucket'] for b in batches]}, decode steps by bucket {steps}, launches by design "
                  f"{designs}  [{smi}]")
            out["caption_batch"] = {"seconds": batch_s, "img_s": HTTP_BATCH / batch_s,
                                    "batches": [len(b["ids"]) for b in batches]}
            nbest = []
            for i in range(NBEST_PROBES):
                status, a = _http(port, "/caption?nbest=1", bytes(blob[offsets[i][0]:offsets[i][1]]))
                assert status == 200 and a["mode"] == "beam" and len(a["nbest"]) == cfg.beam_size, (status, a)
                scores = [x["score"] for x in a["nbest"]]
                assert a["caption"] == a["nbest"][0]["caption"] and scores == sorted(scores, reverse=True), a
                nbest.append((i, a["caption"]))
            if Image is not None:
                status, attn = _http(port, "/caption?attention=1", bytes(blob[offsets[0][0]:offsets[0][1]]))
                assert status == 200 and attn["mode"] == "greedy", (status, attn)
                sheet = Image.open(io.BytesIO(base64.b64decode(attn["attention_sheet_png_b64"])))
                print(f"  POST /caption?attention=1: 200, greedy caption {attn['caption']!r}, a {sheet.size} contact "
                      f"sheet")
            health_status, health = _http(port, "/healthz")
            metrics_status, metrics = _http(port, "/metrics")
        assert health_status == 200 and health["ok"] and health["buckets"] == list(cap.bucket_sizes), health
        vals = _metric_values(metrics)
        want = {"sat_requests_total": HTTP_BATCH, "sat_batched_images_total": HTTP_BATCH,
                'sat_requests_by_mode_total{mode="beam"}': HTTP_BATCH, 'sat_requests_by_mode_total{mode="greedy"}': 0,
                "sat_request_errors_total": 0, "sat_requests_rejected_total": 0, "sat_requests_abandoned_total": 0}
        assert metrics_status == 200 and all(vals[k] == v for k, v in want.items()), vals
        print(f"  /healthz 200 (buckets {health['buckets']}); /metrics parses, its counters equal the requests sent: "
              f"{ {k: int(vals[k]) for k in want} }")

        # 4. a burst against a queue of 2: 429s, counted as rejected
        qsrv = serve_http.make_server(cfg, vocab, "127.0.0.1", 0, captioner=cap, batch_max_queue=BURST_QUEUE)
        servers.append(qsrv)
        del batches[:]
        with _serving(qsrv) as port:
            res = _run_load(tmp, port, "/caption", blob_path, offsets[:BURST], BURST)
            stats = qsrv.batcher.stats()
        codes = [r[1] for r in res["requests"]]
        ok = {r[0]: json.loads(r[3])["caption"] for r in res["requests"] if r[1] == 200}
        n429 = codes.count(429)
        served("beam", ok)
        print(f"  burst of {BURST} against batch_max_queue {BURST_QUEUE}: {len(ok)} answered 200, {n429} answered 429; "
              f"stats rejected {stats['rejected']}, requests {stats['requests']}")
        assert n429 > 0 and len(ok) + n429 == BURST and stats["rejected"] == n429 and stats["requests"] == len(ok)
        out["burst"] = {"ok": len(ok), "429": n429}

        # 5. every served caption against the direct call at its bucket: at a
        # fixed bucket every op is row-independent
        cap.caption_images = call
        direct, direct_s = {}, {}
        checked = {("beam", 1), ("beam", 8), ("beam", 256), ("greedy", 1), ("greedy", 256)}  # read below
        for mode, bucket in sorted({(m, b) for m, _, b, _ in rows} | checked):
            caps = []
            t0 = time.perf_counter()
            for k in range(0, n, bucket):
                caps += cap.caption_images(images[k:k + bucket], mode=mode)
            direct_s[(mode, bucket)] = time.perf_counter() - t0
            direct[(mode, bucket)] = caps
        diff = [(m, i, b, c, direct[(m, b)][i]) for m, i, b, c in rows if c != direct[(m, b)][i]]
        print(f"  {len(rows)} HTTP captions against the direct Captioner.caption_images caption of the same image at "
              f"the same bucket: {len(rows) - len(diff)} equal" + (f"; first difference {diff[0]}" if diff else ""))
        assert not diff and len(rows) == 2 * len(HTTP_LEVELS) * n + HTTP_BATCH + len(ok)
        if Image is not None:
            assert attn["caption"] == direct[("greedy", 1)][0], (attn["caption"], direct[("greedy", 1)][0])
            # cli.caption over 8 of the scenes as PNG files, with contact sheets
            os.makedirs(os.path.join(tmp, "files"))
            files = [os.path.join(tmp, "files", f"scene{i}.png") for i in range(8)]
            for f, img in zip(files, images):
                Image.fromarray(img).save(f)
            printed = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                caption.main(trained["flags"] + ["--load_model_path", trained["expr_dir"], "--attention_dir",
                                                 os.path.join(tmp, "sheets")] + files)
            caption_s = time.perf_counter() - t0
            recs = [json.loads(ln) for ln in printed.getvalue().splitlines()]
            same = [r["caption"] for r in recs] == direct[("beam", 8)][:8]
            print(f"  cli.caption over {len(files)} PNG files with --attention_dir: {caption_s:.2f} s (the Captioner's "
                  f"build, the trunk file, the checkpoint); captions equal the direct beam captions at bucket 8: "
                  f"{same}; {sum(os.path.exists(r['attention_sheet']) for r in recs)} sheets written; the attention "
                  f"request's caption equals the direct greedy caption at bucket 1  [{smi}]")
            assert same and [r["image"] for r in recs] == files and all(os.path.exists(r["attention_sheet"]) for r in recs)
        bad = [(i, c) for i, c in nbest if c != direct[("beam", 1)][i]]
        print(f"  ?nbest=1 on {NBEST_PROBES} images: the best entry is the beam caption at bucket 1 on "
              f"{NBEST_PROBES - len(bad)} of {NBEST_PROBES}; scores not increasing")
        assert not bad, bad
        out["compared"] = len(rows)
        for mode in ("beam", "greedy"):
            own = n / direct_s[(mode, 256)]
            best = max(v["img_s"] for k, v in out["levels"].items() if k.startswith(mode))
            print(f"  {mode:6s} HTTP to direct: best HTTP {best:.1f} img/s against this Captioner's direct "
                  f"caption_images at bucket 256 {own:.1f} img/s = {best / own:.3f}, and against phase 5's (random "
                  f"weights, every batch 20 steps) {direct_img_s[mode]:.1f} img/s = {best / direct_img_s[mode]:.3f}  "
                  f"[{smi}]")
            out[f"direct_{mode}_img_s"] = own
        print(f"  direct calls over the {n} images by bucket, s: "
              f"{ {f'{m}@{b}': round(s, 3) for (m, b), s in sorted(direct_s.items())} }")
    finally:
        serve_http._decode_image = real_decode
    alive = [s for s in servers if s.batcher._worker.is_alive()]
    print(f"  after server_close(): the batcher's worker has exited on {len(servers) - len(alive)} of "
          f"{len(servers)} servers")
    assert not alive

    # 6. cli.export_torch on the same checkpoint, served through cfg.torch_checkpoint
    pth = os.path.join(tmp, "model-best.pth")
    t0 = time.perf_counter()
    export_torch.main(trained["flags"] + ["--load_model_path", trained["expr_dir"], "--export_path", pth])
    export_s = time.perf_counter() - t0
    ecap = Captioner.from_checkpoint(cfg.replace(torch_checkpoint=pth, load_model_path=None), None, vocab)
    same = {mode: ecap.caption_images(images[:256], mode=mode) == direct[(mode, 256)][:256]
            for mode in ("beam", "greedy")}
    print(f"  cli.export_torch: {os.path.getsize(pth) / 1e6:.1f} MB reference-format .pth in {export_s:.2f} s; a "
          f"Captioner from it (cfg.torch_checkpoint) captions 256 images as the served model does: {same}")
    assert all(same.values())
    out["export"] = {"seconds": export_s, "mb": os.path.getsize(pth) / 1e6}
    del ecap, cap, srv0, servers

    # 7. cli.train_chain: one child process per epoch, on the card
    ccfg = parse_config(trained["flags"] + ["--max_epochs", str(CHAIN_EPOCHS), "--save_checkpoint_every", "1000",
                                            "--expr_dir", os.path.join(tmp, "chain")])
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with contextlib.chdir(os.path.dirname(os.path.abspath(__file__))):  # the children import the package from here
        record = train_chain.run_chain(ccfg)
    chain_s = time.perf_counter() - t0
    expr = train_chain.resolved_expr_dir(ccfg)
    with open(os.path.join(expr, f"chain_epoch{CHAIN_EPOCHS}_try1.log")) as fh:
        last = fh.read().rstrip().splitlines()[-1]
    spawns = record["spawns"]
    print(f"  cli.train_chain, {CHAIN_EPOCHS} epochs of 5 steps: {chain_s:.1f} s; children "
          f"{[(s['epoch'], s['returncode'], s['total_iter'], s['wall_s']) for s in spawns]} (epoch, exit code, "
          f"total_iter, seconds); completed_epochs {record['completed_epochs']}; the last child's log ends "
          f"{last!r}  [{smi}]")
    assert record["completed_epochs"] == CHAIN_EPOCHS and [s["returncode"] for s in spawns] == [0] * CHAIN_EPOCHS
    assert spawns[-1]["total_iter"] == 5 * CHAIN_EPOCHS and last.endswith("done"), (spawns, last)
    out["chain"] = {"seconds": chain_s, "child_s": [s["wall_s"] for s in spawns]}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 11: {out['seconds']:.1f} s")
    return out


# --- phase 12: Show-and-Tell on the card ----------------------------------------

ST_SCALED_BATCH = 64  # the scaled configuration (Inception-v3, 2 layers) is held at this batch
ST_SCALED_PX = 342  # uint8 images for crop 299: 299 / 0.875


def _greedy_steps(ids, T):
    """Step functions that a greedy decode with early exit ran after its
    first step, from its ids: until every row holds <end>, at most T - 1."""
    from show_and_tell_tpu_torch.utils.vocab import END_ID

    has_end = ids == END_ID
    first_end = torch.where(has_end.any(1), has_end.int().argmax(1), torch.full_like(ids[:, 0], T))
    return min(int(first_end.max()), T - 1)


def _st_serving(cap, images, label, layers):
    """Captions of ``images`` by beam and greedy: img/s as the median of REPS
    after a warm call, the cell's launches per batch (``layers`` per decode
    step, by wgmma) and no attention kernel. Returns (captions, img/s,
    launches of the cell per mode summed over the timed calls)."""
    from show_and_tell_tpu_torch.ops import cuda_lib

    N, T = images.shape[0], cap.cfg.max_decode_len
    captions, img_s, cell = {}, {}, {}
    for mode in ("beam", "greedy"):
        dt, secs, caps, per_call, designs = _timed_calls(lambda: cap.caption_images(images, mode=mode), REPLACES)
        img_s[mode] = N / dt
        cell[mode] = int(per_call["lstm_cell"] * REPS)
        n = per_call["lstm_cell"]
        others = {k: v for k, v in per_call.items() if k != "lstm_cell" and v}
        print(f"  {label} {mode:6s}: {N} images in {dt * 1e3:.2f} ms (median of {REPS}: "
              f"{', '.join(f'{s * 1e3:.2f}' for s in secs)}) = {N / dt:.1f} img/s; cell launches per batch {n:g} "
              f"({n / layers:g} steps x {layers} layers), designs {designs['lstm_cell']}; caption[0] {caps[0]!r}")
        assert len(caps) == N and all(isinstance(s, str) for s in caps)
        assert not others, f"{label} {mode}: attention kernels launched: {others}"
        assert n % layers == 0 and 1 <= n / layers <= T, f"{label} {mode}: {n} cell launches per batch"
        assert designs["lstm_cell"] == {"wgmma": n}, f"{label} {mode}: cell designs {designs['lstm_cell']}"
        captions[mode] = caps
    return captions, img_s, cell


def _st_logits_vs_plain(model, cfg, x_u8, label):
    """The decode-step logits through the kernels against the same weights on
    the CPU (plain path) fed the card's features: the first step at B, five
    forced steps at B and at B x 3 (the beam's later steps). Returns the
    worst max|diff|/max|logit|."""
    from show_and_tell_tpu_torch.data.transforms import eval_transform
    from show_and_tell_tpu_torch.decode.beam import _tile_beams
    from show_and_tell_tpu_torch.models.registry import build_model

    V = model.vocab_size
    m_cpu = build_model(cfg, V, device="cpu", generator=torch.Generator().manual_seed(SEED + 12))
    m_cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    rng = np.random.default_rng(SEED + 12)
    rtol = LOGITS_RTOL[model.cdtype]
    worst = 0.0
    with torch.inference_mode():
        feats = model.backbone_features(eval_transform(x_u8, cfg.crop_size))
        assert feats.shape == (x_u8.shape[0], 2048) and torch.isfinite(feats).all()
        B = feats.shape[0]
        for k in (1, 3):
            sk, ck, fk, _ = model.decode_state(feats)
            sp, cp, fp, _ = m_cpu.decode_state(feats.cpu())
            worst = max(worst, _diffs(fk.cpu(), fp)[1])
            ck, cp = _tile_beams(ck, k), _tile_beams(cp, k)
            toks = torch.from_numpy(rng.integers(0, V, (5, B * k)))
            for t in range(5):
                ck, lk = sk(ck, toks[t].cuda())
                cp, lp = sp(cp, toks[t])
                assert lk.shape == (B * k, V) and torch.isfinite(lk).all()
                worst = max(worst, _diffs(lk.cpu(), lp)[1])
    print(f"  {label} {cfg.dtype} step logits, kernels vs the plain path on the CPU (B={B} and {3 * B}): "
          f"max|diff|/max|logit| {worst:.3e} (tol {rtol:g})")
    assert worst <= rtol, f"{label} {cfg.dtype}: kernel path logits disagree with the plain path"
    return worst


def _st_train(model, cfg, images, label, steps=(WARM_STEPS, TIMED_STEPS), split=True):
    """TrainStep on uint8 images with synthetic captions (T=20): warm steps,
    then timed ones; the cell's launches per step; the loss finite and
    falling on the fixed batch; the running statistics after one step
    against 0.99 old + 0.01 the batch's, recomputed in fp32 (float64) from
    that step's projected features. Returns the figures."""
    from show_and_tell_tpu_torch.models.layers import dense
    from show_and_tell_tpu_torch.ops import cuda_lib
    from show_and_tell_tpu_torch.train.step import make_train_state, make_train_step
    from show_and_tell_tpu_torch.utils.vocab import START_ID

    V, T, N = model.vocab_size, 20, images.shape[0]
    layers = cfg.num_layers
    state = make_train_state(cfg, model)
    step = make_train_step(model, cfg)
    rng = np.random.default_rng(SEED + 12)
    caps = np.concatenate([np.full((N, 1), START_ID), rng.integers(4, V, (N, T - 1))], 1)
    batch = {"images": torch.from_numpy(images).cuda(), "captions": torch.from_numpy(caps).cuda(),
             "lengths": torch.full((N,), T, device="cuda")}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    lr = cfg.learning_rate
    losses = []
    out = {}

    def one_step():
        nonlocal state
        state, m = step(state, batch, lr, generator=gen)
        losses.append(m["loss"])
        return m

    warm, timed = steps
    cuda_lib.LAUNCHES.clear()
    for _ in range(warm):
        one_step()
    torch.cuda.synchronize()
    if timed:
        t0 = time.perf_counter()
        for _ in range(timed):
            one_step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out.update(img_s=timed * N / dt, ms_per_step=dt * 1e3 / timed)
        print(f"  {label} training: {timed} timed steps at batch {N}: {dt * 1e3 / timed:.2f} ms/step = "
              f"{timed * N / dt:.1f} img/s")

    # one step by phases: the split, and the running statistics it commits
    marks = []

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    total = cuda_lib.LAUNCHES["lstm_cell"]
    cuda_lib.LAUNCHES.clear()
    mark()
    feats = step.features(batch, gen)
    mark()
    loss, _ = step.forward(feats, batch, generator=gen)
    mark()
    grads = step.backward(state, loss)
    mark()
    proj = {k: v.detach().clone() for k, v in model.proj.items()}
    old = {k: v.clone() for k, v in state.batch_stats.items()}
    state, _ = step.apply(state, grads, lr)
    mark()
    losses.append(loss.detach())
    n = cuda_lib.LAUNCHES["lstm_cell"]
    designs = cuda_lib.designs("lstm_cell")
    others = {k: cuda_lib.LAUNCHES[k] for k in REPLACES if k != "lstm_cell" and cuda_lib.LAUNCHES[k]}
    out["split_ms"] = dict(zip(("trunk", "forward", "backward", "apply"),
                               (1e3 * (b - a) for a, b in zip(marks, marks[1:]))))
    if split:
        print(f"  {label} split: " + ", ".join(f"{k} {v:.2f} ms" for k, v in out["split_ms"].items()))
    print(f"  {label} launches per step: cell {n} ((T-1) x {layers} layers = {(T - 1) * layers}), designs "
          f"{designs}; attention kernels {others or 'none'}")
    assert n == (T - 1) * layers and designs == {"wgmma": n} and not others, \
        f"{label}: training launches {n}, designs {designs}, others {others}"
    with torch.no_grad():
        f = dense(proj, feats).double()
        rel = {}
        for k, batch_stat in (("mean", f.mean(0)), ("var", f.var(0, unbiased=True))):
            want = 0.99 * old[k].double() + 0.01 * batch_stat
            rel[k] = float((state.batch_stats[k].double() - want).abs().max() / want.abs().max())
    print(f"  {label} running statistics after the step against 0.99 old + 0.01 the batch's (float64): "
          f"max|diff|/max|value| mean {rel['mean']:.2e}, var {rel['var']:.2e} (limit 1e-5); moved: "
          f"{not torch.equal(old['mean'], state.batch_stats['mean'])}")
    assert max(rel.values()) <= 1e-5 and not torch.equal(old["var"], state.batch_stats["var"])
    out["stats_rel_err"] = rel
    out["launches"] = total + n
    # values of the steps so far (one_step goes on appending to ``losses``)
    values = [float(x) for x in losses]
    print(f"  {label} loss by step: {', '.join(f'{x:.4f}' for x in values)}")
    assert all(np.isfinite(values)) and values[-1] < values[0], f"{label}: the loss is not finite and falling"
    out["losses"] = values
    out["one_step"] = one_step
    return out, state


def phase_show_tell(tmp, images):
    """Show-and-Tell at full width (ResNet-152, one layer) served, trained and
    checkpointed on the card, then the scaled configuration (Inception-v3 at
    299 px, two layers) at batch 64. Returns the figures and, under
    ``launches``, the cell's launches of the phase's runs."""
    from show_and_tell_tpu_torch import ckpt
    from show_and_tell_tpu_torch.ckpt.torch_import import load_reference_checkpoint
    from show_and_tell_tpu_torch.cli import export_torch
    from show_and_tell_tpu_torch.config import Config
    from show_and_tell_tpu_torch.data.transforms import eval_transform
    from show_and_tell_tpu_torch.decode.dispatch import decode_ids
    from show_and_tell_tpu_torch.models.encoders import to_torch_resnet152
    from show_and_tell_tpu_torch.models.registry import build_model
    from show_and_tell_tpu_torch.ops import cuda_lib
    from show_and_tell_tpu_torch.serve import Captioner
    from show_and_tell_tpu_torch.train.step import make_train_state, make_train_step
    from show_and_tell_tpu_torch.utils.vocab import Vocabulary

    t_phase = time.perf_counter()
    V, N = 10000, images.shape[0]
    vocab = Vocabulary.from_words(f"w{i}" for i in range(V - 4))
    cfg = Config(model="show_tell", dtype="bfloat16")
    out = {"launches": 0}
    model = build_model(cfg, V, device="cuda", generator=torch.Generator().manual_seed(SEED))
    print(f"== 12. Show-and-Tell: {cfg.encoder} -> {model.encoder_name}, crop {cfg.crop_size}, E={cfg.embed_size} "
          f"H={cfg.hidden_size} num_layers {cfg.num_layers} V={V}, beam {cfg.beam_size}, {cfg.dtype}, "
          f"{N} uint8 images (phase 5's)")
    cap = Captioner(cfg, model, None, vocab, device="cuda")
    warm = cap.warmup(modes=("beam", "greedy", "attention"), buckets=(N,))
    print(f"  warmup (beam and greedy at bucket {N}; attention skipped: no attention maps): {warm:.2f} s")
    captions, img_s, cell = _st_serving(cap, images, "serving", cfg.num_layers)
    out["launches"] += sum(cell.values())
    out.update(serve_img_s=img_s)

    # trunk and decode apart, a traced decode, and the greedy launches
    # against the steps its ids show
    with torch.inference_mode():
        x = torch.from_numpy(images).cuda()
        split = {}
        for mode in ("beam", "greedy"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feats = model.backbone_features(eval_transform(x, cfg.crop_size))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cuda_lib.LAUNCHES.clear()
            ids = decode_ids(model, cfg, feats, mode)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            n = cuda_lib.LAUNCHES["lstm_cell"]
            out["launches"] += n
            split[mode] = {"trunk_ms": (t1 - t0) * 1e3, "decode_ms": (t2 - t1) * 1e3}
            print(f"  {mode:6s} split: transform+trunk {(t1 - t0) * 1e3:.2f} ms, decode {(t2 - t1) * 1e3:.2f} ms, "
                  f"cell launches {n}")
            if mode == "greedy":
                want = cfg.num_layers * (1 + _greedy_steps(ids, cfg.max_decode_len))
                assert n == want, f"greedy: {n} cell launches, its ids show {want}"
            profile_window(lambda: decode_ids(model, cfg, feats, mode), mode)
        trunk_ms = time_cold(lambda: model.backbone_features(eval_transform(x, cfg.crop_size)), iters=5, warmup=1)
    flops = 2 * 11.56e9 * N  # ResNet-152 at 224 px: 11.56 GMAC per image
    print(f"  trunk (transform + ResNet-152, batch {N}): {trunk_ms:.2f} ms device time against "
          f"{flops / PEAK_FLOPS[torch.bfloat16] * 1e3:.2f} ms at the bf16 peak ({flops / 1e12:.2f} TFLOP)")
    out.update(split=split, trunk_ms=trunk_ms)
    _st_logits_vs_plain(model, cfg, torch.from_numpy(images[:8]).cuda(), "full width")

    # fp32: greedy ids through the kernels against the plain path on the card
    cfg32 = cfg.replace(dtype="float32")
    m32 = build_model(cfg32, V, device="cuda", generator=torch.Generator().manual_seed(SEED))
    _st_logits_vs_plain(m32, cfg32, torch.from_numpy(images[:8]).cuda(), "full width")
    with torch.no_grad():
        f32 = m32.backbone_features(eval_transform(torch.from_numpy(images).cuda(), cfg.crop_size))
        ids = {}
        for path in ("kernels", "plain"):
            cuda_lib.LAUNCHES.clear()
            with plain_ops() if path == "plain" else contextlib.nullcontext():
                ids[path] = decode_ids(m32, cfg32, f32, "greedy")
            torch.cuda.synchronize()
            assert (cuda_lib.LAUNCHES["lstm_cell"] > 0) == (path == "kernels")
        differ = (ids["kernels"] != ids["plain"]).any(1).nonzero().squeeze(1).tolist()
        gaps = []
        for r in differ:  # the plain path's two top logits at the first differing step
            t_diff = int((ids["kernels"][r] != ids["plain"][r]).int().argmax())
            with plain_ops():
                step_fn, carry, logits, _ = m32.decode_state(f32[r:r + 1])
                for s in range(1, t_diff + 1):
                    carry, logits = step_fn(carry, ids["plain"][r:r + 1, s - 1])
            top2 = logits[0].float().topk(2).values
            gaps.append(float(top2[0] - top2[1]))
    print(f"  fp32 greedy ids, kernels vs plain on the card: {N - len(differ)} of {N} identical; differences at "
          f"top-two gaps under {TIE_GAP:g}: {all(g < TIE_GAP for g in gaps)} {gaps[:8]}")
    assert all(g < TIE_GAP for g in gaps), f"fp32 greedy ids differ away from a tie: gaps {gaps}"
    out["fp32_greedy_differ"] = len(differ)

    # training at batch 256
    train, state = _st_train(model, cfg, images, "full width")
    one_step = train.pop("one_step")
    cuda_lib.LAUNCHES.clear()
    profile_window(one_step, "train step")
    out["launches"] += train.pop("launches") + cuda_lib.LAUNCHES["lstm_cell"]
    out["train"] = train
    # one fp32 step's gradients through the kernel against the plain path
    st32, s32 = make_train_state(cfg32, m32), make_train_step(m32, cfg32)
    b32 = {"captions": torch.from_numpy(np.concatenate(
        [np.ones((N, 1), np.int64), np.random.default_rng(SEED + 13).integers(4, V, (N, 19))], 1)).cuda(),
        "lengths": torch.full((N,), 20, device="cuda")}
    grads = {}
    for path in ("kernels", "plain"):
        cuda_lib.LAUNCHES.clear()
        with plain_ops() if path == "plain" else contextlib.nullcontext():
            loss, _ = s32.forward(f32, b32)
            grads[path] = s32.backward(st32, loss)
        torch.cuda.synchronize()
        n = cuda_lib.LAUNCHES["lstm_cell"]
        assert n == (19 if path == "kernels" else 0), f"fp32 {path} step: {n} cell launches"
    rel = {k: _diffs(grads["kernels"][k], grads["plain"][k])[1] for k in grads["plain"]}
    # the projection's bias: the train-mode BatchNorm subtracts the batch
    # mean, so its gradient is zero but for rounding; it is held against the
    # projection weight's gradient scale
    rel["proj.b"] = _maxdiff(grads["kernels"]["proj.b"], grads["plain"]["proj.b"]) / float(
        grads["plain"]["proj.w"].abs().max())
    worst = max(rel, key=rel.get)
    print(f"  fp32 gradients, kernels vs plain, max|diff|/max|grad| (proj.b: / max|grad proj.w|): worst {worst} "
          f"{rel[worst]:.3e} (limit {GRAD_RTOL:g}); " + ", ".join(f"{k} {v:.1e}" for k, v in rel.items()))
    assert rel[worst] <= GRAD_RTOL, "kernel-path gradients disagree with the plain path"
    del m32, st32, s32, grads, f32

    # checkpoints: the trained model through model-best.pt (with its
    # statistics) and a torchvision ResNet-152 file, then cli.export_torch
    captions = {mode: cap.caption_images(images, mode=mode) for mode in ("beam", "greedy")}
    exp = os.path.join(tmp, "show_tell")
    ckpt.save_best(exp, ckpt.trainable_state_dict(model), state.batch_stats, {"iter": 1})
    trunk = os.path.join(tmp, "resnet152.pth")
    torch.save(to_torch_resnet152(model.frozen_tree()), trunk)
    cfg_b = cfg.replace(encoder_weights=trunk)
    back = Captioner.from_checkpoint(cfg_b, exp, vocab)
    assert all(torch.equal(back.model.batch_stats[k], state.batch_stats[k]) for k in ("mean", "var"))
    same = {mode: back.caption_images(images, mode=mode) == captions[mode] for mode in captions}
    print(f"  model-best.pt (params and batch statistics) + a torchvision ResNet-152 file -> "
          f"Captioner.from_checkpoint: captions identical to the trained model's {same}")
    assert all(same.values()), "the restored Show-and-Tell Captioner's captions differ"
    vocab_path = os.path.join(tmp, "show_tell_vocab.json")
    vocab.save(vocab_path)
    pth = os.path.join(tmp, "show_tell.pth")
    export_torch.main(["--model", "show_tell", "--dtype", "bfloat16", "--vocab_path", vocab_path,
                       "--load_model_path", exp, "--export_path", pth])
    t, stats, fr = load_reference_checkpoint(pth, model="show_tell", num_layers=cfg.num_layers)
    assert fr is None and all(torch.equal(stats[k], state.batch_stats[k].cpu()) for k in stats)
    ref = Captioner.from_checkpoint(cfg_b.replace(torch_checkpoint=pth), None, vocab)
    same = {mode: ref.caption_images(images, mode=mode) == captions[mode] for mode in captions}
    print(f"  cli.export_torch -> reference .pth ({os.path.getsize(pth) / 1e6:.1f} MB, {len(t)} decoder and encoder "
          f"tensors + statistics) -> Captioner (cfg.torch_checkpoint): captions identical {same}")
    assert all(same.values()), "the exported .pth's captions differ"
    del back, ref, cap, model, state

    # the scaled configuration: Inception-v3 at crop 299, two layers, batch 64
    cfg_s = Config(model="show_tell", encoder="inception_v3", crop_size=299, num_layers=2, dtype="bfloat16")
    ms = build_model(cfg_s, V, device="cuda", generator=torch.Generator().manual_seed(SEED + 1))
    px = np.random.default_rng(SEED + 14).integers(0, 256, (ST_SCALED_BATCH, ST_SCALED_PX, ST_SCALED_PX, 3),
                                                  dtype=np.uint8)
    print(f"  scaled configuration: {ms.encoder_name}, crop {cfg_s.crop_size}, num_layers {cfg_s.num_layers}, batch "
          f"{ST_SCALED_BATCH} of {ST_SCALED_PX}-px uint8 images through the Captioner (its centre crop takes any "
          f"size of at least the crop)")
    caps_s = Captioner(cfg_s, ms, None, vocab, device="cuda", bucket_sizes=(ST_SCALED_BATCH,))
    _, img_s_s, cell_s = _st_serving(caps_s, px, "scaled", cfg_s.num_layers)
    out["launches"] += sum(cell_s.values())
    _st_logits_vs_plain(ms, cfg_s, torch.from_numpy(px[:8]).cuda(), "scaled")
    train_s, _ = _st_train(ms, cfg_s, px, "scaled", steps=(1, 0), split=False)
    out["launches"] += train_s.pop("launches")
    train_s.pop("one_step")
    out["scaled"] = {"serve_img_s": img_s_s, "train": train_s}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 12: {out['seconds']:.1f} s")
    return out


# --- phase 13: the int8 trunk on the card ----------------------------------------

# bench.py's int8 quality gate (bench.py:139-183), int8 / bf16 on the same
# held-out scenes and the same trained decoder: a miss raises
INT8_EXACT_MIN_RATIO, INT8_CIDER_MIN_RATIO = 0.90, 0.95
INT8_CALIB = 32  # calibration images, as the Captioner takes them
PEAK_INT8_OPS = 1979e12  # dense int8 tensor-core operations per second
INT8_TRUNK_ITERS = 5  # timed trunk calls (device time, median)


@contextlib.contextmanager
def _recording_gemms(shapes):
    """Record (M, K, N) of each int8 GEMM of the int8 trunk."""
    from show_and_tell_tpu_torch.models import quantize

    int_mm = quantize._int_mm

    def recorded(a, b):
        shapes.append((a.shape[0], a.shape[1], b.shape[1]))
        return int_mm(a, b)

    quantize._int_mm = recorded
    try:
        yield
    finally:
        quantize._int_mm = int_mm


def _int8_trunk(model, x, label, bf16_ms=None):
    """The int8 trunk on ``x``: device ms (CUDA events, median of
    INT8_TRUNK_ITERS, L2 flushed) beside its bound, the int8 operations that
    this call's GEMMs do at the dense int8 rate, the peak memory of one call,
    and a traced call's busy share and largest kernels. Returns the
    figures."""
    shapes = []
    with torch.inference_mode():
        with _recording_gemms(shapes):
            feats = model.backbone_features(x)
        torch.cuda.synchronize()
        assert feats.dtype == torch.float32 and torch.isfinite(feats).all(), f"{label}: int8 features"
        ops = sum(2 * m * k * n for m, k, n in shapes)
        ms = time_cold(lambda: model.backbone_features(x), iters=INT8_TRUNK_ITERS, warmup=1)
        torch.cuda.reset_peak_memory_stats()
        model.backbone_features(x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        bound = ops / PEAK_INT8_OPS * 1e3
        beside = f", the bf16 trunk {bf16_ms:.2f} ms (int8 / bf16 {ms / bf16_ms:.3f})" if bf16_ms else ""
        print(f"  {label} int8 trunk (batch {x.shape[0]}, {len(shapes)} int8 GEMMs, "
              f"{sum(m <= 16 for m, _, _ in shapes)} padded): {ms:.2f} ms device time against its bound "
              f"{bound:.2f} ms ({ops / 1e12:.2f} T int8 operations at {PEAK_INT8_OPS / 1e12:.0f} TOPS, "
              f"{bound / ms:.1%}){beside}; peak memory {peak:.2f} GB")
        profile_window(lambda: model.backbone_features(x), f"{label} int8 trunk")
    return {"ms": ms, "bound_ms": bound, "int8_tops": ops / 1e12, "gemms": len(shapes), "peak_gb": peak,
            "bf16_ms": bf16_ms}


def _cider(captions, refs):
    from show_and_tell_tpu_torch.metrics.cider import Cider

    score, _ = Cider().compute_score({i: r for i, r in enumerate(refs)}, {i: [c] for i, c in enumerate(captions)})
    return float(score)


def _cosines(model, x):
    """(int8, bf16) trunk features' mean cosine against the fp32 trunk's."""
    from show_and_tell_tpu_torch.models import encoders, quantize

    with torch.inference_mode():
        frozen = model.frozen_tree()
        f32 = encoders.encoder_apply(model.encoder_name)(frozen, x.float()).float().cpu().numpy()
        bf16 = encoders.encoder_apply(model.encoder_name)(frozen, x.bfloat16()).float().cpu().numpy()
        int8 = quantize.backbone_features_q(model.quantized, x).cpu().numpy()
    return quantize._cosine(f32, int8), quantize._cosine(f32, bf16)


def phase_int8(tmp, smi, decoder, trained, images, st_trunk_ms, bf16_eval_cider):
    """The int8 trunk (``Config.quantize_backbone``) through the port's entry
    points at full width: Show-Attend-Tell on VGG16 over phase 9's trained
    decoder and held-out scenes (calibration seconds, img/s beside bf16, the
    trunk beside its bound and the bf16 trunk, the cosine against fp32, the
    quality gate), Show-and-Tell on ResNet-152 over phase 5's images, the
    scaled Inception-v3, then ``warmup`` without calibration images, a second
    ``Captioner`` on the saved calibration, ``cli.evaluate`` (its CIDEr
    beside phase 10's bf16 one, ``bf16_eval_cider``) and a ``Trainer`` with
    ``quantize_backbone``. Returns the figures and, under ``launches``, the
    kernels' launches of the int8 runs."""
    from show_and_tell_tpu_torch.cli import evaluate as cli_evaluate
    from show_and_tell_tpu_torch.cli import main as cli_main
    from show_and_tell_tpu_torch.config import Config, parse_config
    from show_and_tell_tpu_torch.data.transforms import eval_transform
    from show_and_tell_tpu_torch.models import quantize
    from show_and_tell_tpu_torch.models.registry import build_model
    from show_and_tell_tpu_torch.ops import cuda_lib
    from show_and_tell_tpu_torch.serve import Captioner
    from show_and_tell_tpu_torch.utils.vocab import Vocabulary

    t_phase = time.perf_counter()
    rows = ("lstm_cell", "additive_attention", "attention_beam")
    launches = {k: 0 for k in rows}
    out = {"card": smi}

    def count(fn):
        """Run ``fn`` on the int8 path; its kernels' launches join the phase's."""
        before = {k: cuda_lib.LAUNCHES[k] for k in rows}
        result = fn()
        torch.cuda.synchronize()
        for k in rows:
            launches[k] += cuda_lib.LAUNCHES[k] - before[k]
        return result

    def calibrate(cap, calib):
        """Seconds of the Captioner's calibration on ``calib`` (its warmup
        with calibration images and no decode)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        count(lambda: cap.warmup(modes=(), calib_images=calib))
        secs = time.perf_counter() - t0
        assert quantize.is_quantized(cap.model.quantized), "the Captioner did not calibrate"
        return secs

    def serve(cap, imgs, label):
        """img/s of beam and greedy (median of REPS after a warm call) and
        the captions by mode; the int8 runs' launches are counted."""
        caps, img_s = {}, {}
        for mode in ("beam", "greedy"):
            dt, secs, got, per_call, designs = _timed_calls(lambda: cap.caption_images(imgs, mode=mode), rows)
            img_s[mode] = imgs.shape[0] / dt
            caps[mode] = got
            if cap.cfg.quantize_backbone:
                for k in rows:
                    launches[k] += int(per_call[k] * REPS)
                assert per_call["lstm_cell"] > 0, f"{label} {mode}: no cell launch"
            print(f"  {label} {mode:6s}: {imgs.shape[0]} images in {dt * 1e3:.2f} ms (median of {REPS}: "
                  f"{', '.join(f'{x * 1e3:.2f}' for x in secs)}) = {img_s[mode]:.1f} img/s; launches per batch "
                  f"{ {k: v for k, v in per_call.items() if v} }")
        return caps, img_s

    # 1. Show-Attend-Tell on VGG16: phase 9's trained decoder, its held-out scenes
    cfg, vocab = decoder["cfg"], decoder["vocab"]
    V, refs, scenes = len(vocab), decoder["refs"], decoder["eval_images"]
    N = scenes.shape[0]

    def sat_model():
        m = build_model(cfg, V, device="cuda", generator=torch.Generator().manual_seed(SEED))
        m.load_state_dict(decoder["state"])
        return m

    path = os.path.join(tmp, "vgg16.int8.pt")
    cfg8 = cfg.replace(quantize_backbone=True, quantized_backbone_path=path)
    print(f"== 13. the int8 trunk (quantize_backbone: per-channel int8 weights, calibrated activation scales, "
          f"im2col + torch._int_mm, fp32 epilogue): {cfg.model} {cfg.encoder} crop {cfg.crop_size} {cfg.dtype} "
          f"decoder, phase 9's trained weights and {N} held-out scenes  [{smi}]")
    # torch._int_mm's limits on this card, which the int8 conv keeps within:
    # more than 16 rows, K and N multiples of 8, the weight column-major
    a = torch.randint(-127, 128, (17, 64), dtype=torch.int8, device="cuda", generator=_gen(SEED))
    b = torch.randint(-127, 128, (64, 64), dtype=torch.int8, device="cuda", generator=_gen(SEED + 1))

    def col(t):
        return t.t().contiguous().t()

    limits = {}
    for label, (aa, bb) in {"M=17 K=64 N=64, B column-major": (a, col(b)), "M=17, B row-major": (a, b),
                            "M=16": (a[:16], col(b)), "K=60": (a[:, :60], col(b[:60])),
                            "N=60": (a, col(b[:, :60]))}.items():
        try:
            got = torch._int_mm(aa, bb).cpu()
            limits[label] = "exact" if torch.equal(got, aa.cpu().int() @ bb.cpu().int()) else "WRONG"
        except RuntimeError as e:
            limits[label] = "raises (" + str(e).splitlines()[0][:90] + ")"
    print("  torch._int_mm on this card: " + "; ".join(f"{k}: {v}" for k, v in limits.items()))
    assert limits["M=17 K=64 N=64, B column-major"] == "exact" and "raises" in limits["M=16"]
    out["int_mm_limits"] = limits

    cap16 = Captioner(cfg, sat_model(), None, vocab, device="cuda")
    cap8 = Captioner(cfg8, sat_model(), None, vocab, device="cuda")
    calib_s = calibrate(cap8, decoder["train_images"][:INT8_CALIB])
    print(f"  calibration on {INT8_CALIB} training scenes (Captioner.warmup(calib_images=...): an fp32 replay of "
          f"the trunk and the weights' quantization): {calib_s:.2f} s; saved to quantized_backbone_path "
          f"({os.path.getsize(path) / 1e6:.1f} MB)")
    caps16, img16 = serve(cap16, scenes, "bf16")
    caps8, img8 = serve(cap8, scenes, "int8")
    gate = {}
    for mode in ("beam", "greedy"):
        exact = {k: sum(c in refs[i] for i, c in enumerate(caps[mode])) / N for k, caps in (("bf16", caps16),
                                                                                              ("int8", caps8))}
        cider = {"bf16": _cider(caps16[mode], refs), "int8": _cider(caps8[mode], refs)}
        ratios = {"exact": exact["int8"] / exact["bf16"] if exact["bf16"] else 1.0,
                  "cider": cider["int8"] / cider["bf16"] if cider["bf16"] else 1.0}
        same = sum(a == b for a, b in zip(caps8[mode], caps16[mode]))
        gate[mode] = {"exact": exact, "cider": cider, "ratios": ratios, "same_captions": same}
        print(f"  {mode:6s} quality: exact-caption rate bf16 {exact['bf16']:.4f}, int8 {exact['int8']:.4f} "
              f"(ratio {ratios['exact']:.4f}, min {INT8_EXACT_MIN_RATIO}); CIDEr bf16 {cider['bf16']:.4f}, int8 "
              f"{cider['int8']:.4f} (ratio {ratios['cider']:.4f}, min {INT8_CIDER_MIN_RATIO}); {same} of {N} "
              f"captions identical; int8 / bf16 img/s {img8[mode] / img16[mode]:.3f}")
    # bench.py gates beam search, the serving default; greedy is held to the same bound
    for mode, g in gate.items():
        if g["ratios"]["exact"] < INT8_EXACT_MIN_RATIO or g["ratios"]["cider"] < INT8_CIDER_MIN_RATIO:
            raise AssertionError(f"int8 quality gate failed ({mode}): {g}")
    x = eval_transform(torch.from_numpy(scenes).cuda(), cfg.crop_size)
    with torch.inference_mode():
        bf16_ms = time_cold(lambda: cap16.model.backbone_features(x), iters=INT8_TRUNK_ITERS, warmup=1)
    trunk = _int8_trunk(cap8.model, x, "VGG16", bf16_ms)
    cos, cos16 = _cosines(cap8.model, x)
    print(f"  VGG16 feature cosine against the fp32 trunk on the {N} held-out scenes: int8 {cos:.5f}, bf16 "
          f"{cos16:.5f}")
    assert cos > 0.97, cos
    out["sat_vgg16"] = {"calib_s": calib_s, "img_s": {"bf16": img16, "int8": img8}, "gate": gate, "trunk": trunk,
                        "cosine": cos, "cosine_bf16": cos16}

    # 4a. warmup without calibration images leaves the trunk float; a second
    # Captioner on the saved calibration loads the same scales
    capw = Captioner(cfg.replace(quantize_backbone=True), sat_model(), None, vocab, device="cuda", bucket_sizes=(8,))
    capw.warmup(modes=("greedy",))
    assert capw.model.quantized is None, "warmup calibrated on its dummies"
    capb = Captioner(cfg8, sat_model(), None, vocab, device="cuda", bucket_sizes=(8,))
    count(lambda: capb.warmup(modes=("greedy",)))
    same_sx = all(torch.equal(a["sx"], b["sx"]) for a, b in zip(capb.model.quantized["qconvs"],
                                                                cap8.model.quantized["qconvs"]))
    print(f"  warmup() without calib_images: trunk left float (quantized is None: {capw.model.quantized is None}); "
          f"a second Captioner on quantized_backbone_path: the same {len(capb.model.quantized['qconvs'])} sx "
          f"{same_sx}")
    assert same_sx
    del cap16, cap8, capw, capb, x
    torch.cuda.empty_cache()

    # 2. Show-and-Tell on ResNet-152 (phase 12's configuration and seed) over phase 5's images
    cfg_st = Config(model="show_tell", dtype="bfloat16")
    st_vocab = Vocabulary.from_words(f"w{i}" for i in range(10000 - 4))

    def st_model(c):
        return build_model(c, 10000, device="cuda", generator=torch.Generator().manual_seed(SEED))

    st16 = Captioner(cfg_st, st_model(cfg_st), None, st_vocab, device="cuda")
    st8 = Captioner(cfg_st.replace(quantize_backbone=True), st_model(cfg_st), None, st_vocab, device="cuda")
    st_calib = calibrate(st8, images[:INT8_CALIB])
    print(f"  ResNet-152 ({cfg_st.model}, {cfg_st.num_layers} layer, {cfg_st.dtype}): calibration on "
          f"{INT8_CALIB} of phase 5's images {st_calib:.2f} s")
    st_caps16 = {mode: st16.caption_images(images, mode=mode) for mode in ("beam", "greedy")}
    st_caps8, st_img8 = serve(st8, images, "ResNet-152 int8")
    same = {mode: sum(a == b for a, b in zip(st_caps8[mode], st_caps16[mode])) for mode in st_caps8}
    print(f"  ResNet-152 int8 captions identical to bf16's: {same} of {images.shape[0]} (random weights)")
    xs = eval_transform(torch.from_numpy(images).cuda(), cfg_st.crop_size)
    st_trunk = _int8_trunk(st8.model, xs, "ResNet-152", st_trunk_ms)
    st_cos, st_cos16 = _cosines(st8.model, xs[INT8_CALIB:])
    print(f"  ResNet-152 feature cosine against the fp32 trunk on the {images.shape[0] - INT8_CALIB} images held "
          f"out from calibration: int8 {st_cos:.5f}, bf16 {st_cos16:.5f}")
    assert st_cos > 0.95, st_cos
    out["st_resnet152"] = {"calib_s": st_calib, "img_s": st_img8, "same_as_bf16": same, "trunk": st_trunk,
                           "cosine": st_cos, "cosine_bf16": st_cos16}
    del st16, st8, xs
    torch.cuda.empty_cache()

    # 3. the scaled configuration: Inception-v3 at 299 px, two layers, batch 64
    cfg_s = Config(model="show_tell", encoder="inception_v3", crop_size=299, num_layers=2, dtype="bfloat16",
                   quantize_backbone=True)
    px = np.random.default_rng(SEED + 14).integers(0, 256, (ST_SCALED_BATCH, ST_SCALED_PX, ST_SCALED_PX, 3),
                                                  dtype=np.uint8)
    sc8 = Captioner(cfg_s, build_model(cfg_s, 10000, device="cuda", generator=torch.Generator().manual_seed(SEED + 1)),
                    None, st_vocab, device="cuda", bucket_sizes=(ST_SCALED_BATCH,))
    sc_calib = calibrate(sc8, px[:INT8_CALIB])
    _, sc_img8 = serve(sc8, px, "Inception-v3 int8")
    xi = eval_transform(torch.from_numpy(px).cuda(), cfg_s.crop_size)
    quantized, sc8.model.quantized = sc8.model.quantized, None
    with torch.inference_mode():
        sc_bf16_ms = time_cold(lambda: sc8.model.backbone_features(xi), iters=INT8_TRUNK_ITERS, warmup=1)
    sc8.model.quantized = quantized
    sc_trunk = _int8_trunk(sc8.model, xi, "Inception-v3", sc_bf16_ms)
    sc_cos, sc_cos16 = _cosines(sc8.model, xi[INT8_CALIB:])
    print(f"  Inception-v3 (crop {cfg_s.crop_size}, {cfg_s.num_layers} layers, batch {ST_SCALED_BATCH}): calibration "
          f"{sc_calib:.2f} s; feature cosine against the fp32 trunk on {ST_SCALED_BATCH - INT8_CALIB} held-out "
          f"images: int8 {sc_cos:.5f}, bf16 {sc_cos16:.5f}")
    assert sc_cos > 0.95, sc_cos
    out["scaled_inception_v3"] = {"calib_s": sc_calib, "img_s": sc_img8, "trunk": sc_trunk, "cosine": sc_cos,
                                  "cosine_bf16": sc_cos16}
    del sc8, xi
    torch.cuda.empty_cache()

    # 4b. cli.evaluate and a Trainer (cli.main) with quantize_backbone, on phase 10's corpus
    flags = trained["flags"] + ["--quantize_backbone", "true"]
    before = quantize.GEMMS["int_mm"]
    t0 = time.perf_counter()
    loss, preds, stats = count(lambda: cli_evaluate.main(flags + ["--load_model_path", trained["expr_dir"],
                                                                  "--beam_size", "1"]))
    secs = time.perf_counter() - t0
    gemms = quantize.GEMMS["int_mm"] - before
    print(f"  cli.evaluate --quantize_backbone (greedy, phase 10's best checkpoint): val loss {loss:.4f}, CIDEr "
          f"{stats['CIDEr']:.4f} (phase 10's bf16 {bf16_eval_cider:.4f}: ratio {stats['CIDEr'] / bf16_eval_cider:.4f}, "
          f"printed, not gated), {len(preds)} images in {secs:.2f} s, {gemms} int8 GEMMs")
    assert np.isfinite(loss) and gemms > 0
    steps = []
    cfg_t = parse_config(flags + ["--max_epochs", "1", "--save_checkpoint_every", "1000", "--language_eval", "0",
                                  "--expr_dir", os.path.join(tmp, "int8_exp")])
    before = quantize.GEMMS["int_mm"]
    t0 = time.perf_counter()
    with _recording_steps(steps):
        trainer = count(lambda: cli_main.main(cfg_t))
    secs = time.perf_counter() - t0
    losses = [float(st["loss"]) for st in steps]
    gemms = quantize.GEMMS["int_mm"] - before
    print(f"  cli.main --quantize_backbone: the Trainer calibrated on its first batch "
          f"({quantize._quantized_kind(trainer.model.quantized)}) and took {len(steps)} steps at batch "
          f"{cfg_t.batch_size} in {secs:.2f} s, {gemms} int8 GEMMs; losses {', '.join(f'{x:.4f}' for x in losses)}")
    assert quantize.is_quantized(trainer.model.quantized) and steps and all(np.isfinite(losses))
    assert gemms >= 11 * len(steps), gemms
    out["cli"] = {"evaluate": {"val_loss": loss, "lang_stats": stats, "bf16_cider": bf16_eval_cider},
                  "train_losses": losses}
    del trainer
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 13 launches {launches}; phase 13: {out['seconds']:.1f} s")
    return out


class _LogLines(logging.Handler):
    """Collects the trainer's step lines as (epoch, step, loss, img/s,
    ms/step)."""

    def __init__(self, lines):
        super().__init__(logging.INFO)
        self.lines = lines

    def emit(self, record):
        if record.msg.startswith("Epoch ["):
            epoch, _, it, loss, _, img_s, ms = record.args
            self.lines.append((epoch, it, loss, img_s, ms))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the kernel results as JSON to this path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on the GPU", file=sys.stderr)
        return 1
    # the port itself: importable only from a checkout of the repository
    import show_and_tell_tpu_torch  # noqa: F401

    t_start = time.perf_counter()
    smi = phase_environment()
    phase_build()
    errs = phase_check()
    rows, st_cell_rows = phase_times()
    probe_launches = phase_probe()
    launches, model, cfg, images, captions, serve_img_s = phase_end_to_end()
    launches.update(probe_launches)
    launches.update(phase_beam_routes(model, cfg, images))
    training, train_state, train_cfg = phase_training(images)
    # phase 8's launches stay in its own lines and in the --out file's "serving"
    serving = phase_serving_rest(model, cfg, images, captions, train_state, train_cfg)
    del model, train_state
    # phase 9's launches stay in its own lines and in the --out file's "eval"
    evaluation, decoder = phase_eval(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        # phase 10's likewise, under "train_cli"
        train_cli, trained = phase_train_cli(smi, training["img_s"], tmp)
        # phase 11 serves phase 10's best checkpoint; its figures go under "http"
        http = phase_http(smi, trained, tmp, serve_img_s)
        # phase 12's cell launches join the kernels line; its figures go under "show_tell"
        show_tell = phase_show_tell(tmp, images)
        # phase 13's launches join the kernels line; its figures go under "int8"
        int8 = phase_int8(tmp, smi, decoder, trained, images, show_tell["trunk_ms"],
                          train_cli["evaluate"]["beam1"]["lang_stats"]["CIDEr"])
    launches["lstm_cell"] += show_tell["launches"]
    for k, n in int8["launches"].items():
        launches[k] += n
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": errs[name], **rows[name]}
        for name in REPLACES
    ]
    print(f"== done in {time.perf_counter() - t_start:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "kernels": kernels, "training": training, "serving": serving,
                       "eval": evaluation, "train_cli": train_cli, "http": http, "show_tell": show_tell, "int8": int8,
                       "show_tell_cell": st_cell_rows}, fh, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
