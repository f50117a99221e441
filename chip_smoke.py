#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py [--out results.json]

Phases, each printing its own lines:

1. environment: the card's name and power limit, the torch and CUDA versions,
   and the TF32 switches, which are set to False so that the fp32 checks run
   in full fp32 (cuDNN convolutions default to TF32);
2. build: the hand-written kernels from ``show_and_tell_tpu_torch/csrc/``,
   one ``nvcc`` per source, all started together;
3. each of the seven kernels against its plain PyTorch version on the card, at
   the serving shapes and at unaligned and ragged ones (the cell: B=300,
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
   card.

The line before the last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. Any failed check raises, and the
script exits non-zero. Without CUDA it exits non-zero before any result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
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

    print("== 2. build")
    secs = cuda_lib.build_all()
    print(f"built {', '.join(cuda_lib.SOURCES)} for sm_90a in {secs:.1f} s")
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
        # then: ragged B, ragged H and k-tiles on the TMA path, one row; ragged
        # H, I+H not a multiple of the k-tile, and I not a multiple of the
        # vector width (element-wise loads)
        for B, I, H, serving in ((768, 1024, 1024, True), (256, 1024, 1024, True),
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
            ("additive_attention", 7, 1, 13, 40, False),
            ("additive_attention", 1, 1, 196, 512, False),
            ("additive_attention", 256, 1, 1, 512, False),
            ("additive_attention", 256, 1, 13, 512, False),
            ("additive_attention", 64, 1, 197, 512, False),
            ("additive_attention", 16, 1, 196, 1000, False),
            ("additive_attention", 16, 1, 196, 1024, False),
            ("additive_attention", 5, 1, 13, 36, False),
            ("attention_beam", 256, 3, 196, 512, True),
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
    return rows


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
        print(f"  {mode:6s}: {N} images in {dt * 1e3:.2f} ms (median of {REPS}: "
              f"{', '.join(f'{s * 1e3:.2f}' for s in secs)}) = {N / dt:.1f} img/s  launches {counts}")
        print(f"  {mode:6s} caption[0]: {caps[0]!r}")
        assert len(caps) == N and all(isinstance(s, str) for s in caps)
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
    return launches, model, cfg, images


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
    from show_and_tell_tpu_torch.ops import attention, lstm

    saved = sat.fused_additive_attention, sat.lstm_cell
    sat.fused_additive_attention, sat.lstm_cell = attention.additive_attention, lstm.lstm_cell_reference
    try:
        yield
    finally:
        sat.fused_additive_attention, sat.lstm_cell = saved


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
    del state, step, model, feats, loss

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
            "launches_per_step": counts, "losses": losses, "grad_rel_err": rel}


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
    rows = phase_times()
    probe_launches = phase_probe()
    launches, model, cfg, images = phase_end_to_end()
    launches.update(probe_launches)
    launches.update(phase_beam_routes(model, cfg, images))
    del model
    training = phase_training(images)
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": errs[name], **rows[name]}
        for name in REPLACES
    ]
    print(f"== done in {time.perf_counter() - t_start:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "kernels": kernels, "training": training}, fh, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
