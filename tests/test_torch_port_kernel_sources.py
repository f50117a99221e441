"""PyTorch port, the CUDA sources and the choices made before a launch.

Runs without nvcc or a card: the sources are read as text, and the design
and cluster choices are pure functions of shape, dtype and alignment. The
kernels themselves are held against their plain versions on the card by
chip_smoke.py.
"""

import math
import os
import re

import numpy as np
import pytest
import torch

from show_and_tell_tpu_torch.ops import cuda_lib
from show_and_tell_tpu_torch.ops import fused_attention as tfa
from show_and_tell_tpu_torch.ops import fused_decode_attention as tfda
from show_and_tell_tpu_torch.ops import lstm as tlstm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_EXTERN = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')
# the bound the ex2-based tanh of csrc/decode_attention.cu keeps (PERF.md)
TANH_EX2_BOUND = 5e-7


def _source(name):
    with open(os.path.join(cuda_lib.CSRC, name)) as fh:
        return fh.read()


def test_sources_are_the_csrc_files():
    on_disk = sorted(f for f in os.listdir(cuda_lib.CSRC) if f.endswith(".cu"))
    assert sorted(cuda_lib.SOURCES) == on_disk
    assert sorted(cuda_lib._SIGNATURES) == on_disk
    # the headers the sources include are the .cuh files, and part of the hash
    assert sorted(cuda_lib.HEADERS) == sorted(f for f in os.listdir(cuda_lib.CSRC) if f.endswith(".cuh"))
    included = {h for src in on_disk for h in re.findall(r'#include "(\w+\.cuh)"', _source(src))}
    assert included == set(cuda_lib.HEADERS)


@pytest.mark.parametrize("src", sorted(cuda_lib._SIGNATURES))
def test_every_extern_c_function_is_bound(src):
    """Each extern "C" function of a source has a ctypes signature with as
    many parameters, and each signature has a function."""
    defined = {name: [a for a in params.split(",") if a.strip()]
               for name, params in _EXTERN.findall(_source(src))}
    bound = cuda_lib._SIGNATURES[src]
    assert sorted(defined) == sorted(bound), src
    for name, params in defined.items():
        assert len(params) == len(bound[name]), (src, name, params)


@pytest.mark.parametrize("src", sorted(cuda_lib._SIGNATURES))
def test_every_source_names_the_tpu_kernel_it_replaces(src):
    """The header of each source names, as `path` `function`, the Pallas
    kernels it replaces (of the JAX package, or of its attention benchmark),
    and they exist there."""
    header = []
    for line in _source(src).splitlines():
        if not line.startswith("//"):
            break
        header.append(line[2:])
    text = " ".join(header)
    files = re.findall(r"((?:show_and_tell_tpu|benchmarks)/[\w/]+\.py)", text)
    fns = re.findall(r"`(_\w+|kern)`", text)
    assert files and fns, f"{src}: the header names no TPU kernel"
    for path in files:
        with open(os.path.join(REPO, path)) as fh:
            code = fh.read()
        assert any(re.search(rf"^\s*def {fn}\(", code, re.M) for fn in fns), (src, path, fns)


# --- the cell: which design, which tile ---------------------------------------

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("B,I,H,dtype,aligned,want", [
    (768, 1024, 1024, BF16, True, ("wgmma", 192)),  # beam-3 serving: 256 images x 3
    (256, 1024, 1024, BF16, True, ("wgmma", 64)),  # greedy serving and training
    (300, 1024, 1024, BF16, True, ("wgmma", 128)),  # ragged B
    (1, 1024, 1024, BF16, True, ("wgmma", 64)),
    (4, 1000, 1000, BF16, True, ("wgmma", 64)),  # ragged H and k-tiles on TMA
    (13, 40, 24, BF16, True, ("wgmma", 64)),
    (9, 48, 40, BF16, True, ("wgmma", 64)),
    (5, 17, 20, BF16, True, ("tiled", 64)),  # I not a multiple of 8
    (256, 1024, 1024, BF16, False, ("tiled", 64)),  # a misaligned operand
    (768, 1024, 1024, F32, True, ("tiled", 64)),
    (13, 40, 24, F32, True, ("tiled", 64)),
])
def test_cell_design(B, I, H, dtype, aligned, want):
    assert tlstm.cell_design(B, I, H, dtype, aligned) == want


def test_cell_tile_fills_the_card():
    """The wgmma tile takes the fewest rows of work per SM over the three
    tiles, for batches up to 1024, and every design is a known name."""
    for B in range(1, 1025, 7):
        design, bm = tlstm.cell_design(B, 1024, 1024, BF16, True)
        assert design in tlstm.CELL_DESIGNS

        def rows_per_sm(t):
            return math.ceil(math.ceil(B / t) * 32 / tlstm.H100_SMS) * t

        assert rows_per_sm(bm) == min(rows_per_sm(t) for t in (64, 128, 192)), B


# --- the beam attention: cluster size and load mode ---------------------------


@pytest.mark.parametrize("K", range(2, 9))
@pytest.mark.parametrize("L,C", [(1, 1), (13, 1), (196, 4)])
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_beam_plan(K, L, C, dtype):
    """C from L at the model's D=512, f in shared memory within its limit."""
    es = torch.tensor([], dtype=dtype).element_size()
    got_c, mode = tfda.beam_plan(K, L, 512, es, True)
    assert (got_c, mode) == (C, "f_bulk")
    assert tfda.beam_smem_bytes(K, L, 512, C, es, mode) <= tfda.SMEM_LIMIT


def test_beam_plan_falls_back_to_direct_loads():
    assert tfda.beam_plan(3, 13, 36, 2, True) == (1, "direct")  # 72-byte rows
    assert tfda.beam_plan(3, 196, 512, 2, False) == (4, "direct")  # misaligned
    assert tfda.beam_plan(3, 13, 36, 4, True) == (1, "f_bulk")  # 144-byte rows
    # a share too large for one block doubles C, then gives up on bulk copies
    C, mode = tfda.beam_plan(8, 4096, 1024, 4, True)
    assert C == 8 and mode == "direct"
    C, mode = tfda.beam_plan(3, 700, 512, 4, True)
    assert C == 8 and mode == "f_bulk"


def test_beam_smem_layout_matches_the_source():
    """The Python planner's layout constants are the kernel's."""
    src = _source("decode_attention.cu")
    assert f"BAR_BYTES = {tfda._BAR_BYTES};" in src
    assert f"CMAX = {tfda._CLUSTER_MAX};" in src
    modes = re.search(r"enum Mode \{([^}]*)\}", src).group(1)
    assert [m.split("=")[0].strip().lower() for m in modes.split(",")] == list(tfda.BEAM_MODES)


# --- the per-row attention and the scores kernel: which design, how many blocks

# (B, L, D, dtype, aligned) -> (design, C): the serving and training shape, the
# edge shapes the card run holds, and what the one-pass design cannot take
ROW_PLANS = [
    (256, 196, 512, BF16, True, ("onepass", 1)),
    (256, 196, 512, F32, True, ("onepass", 1)),
    (132, 196, 512, BF16, True, ("onepass", 1)),
    (64, 197, 512, BF16, True, ("onepass", 3)),  # 3 x 64 blocks fill 132 SMs
    (16, 196, 512, BF16, True, ("onepass", 8)),  # the largest cluster
    (1, 196, 512, BF16, True, ("onepass", 8)),
    (1, 13, 512, BF16, True, ("onepass", 2)),  # at least 8 rows per block
    (256, 1, 512, BF16, True, ("onepass", 1)),
    (256, 13, 512, BF16, True, ("onepass", 1)),
    (16, 196, 1000, BF16, True, ("onepass", 8)),
    (16, 196, 1024, BF16, True, ("onepass", 8)),
    (7, 13, 40, BF16, True, ("onepass", 2)),  # 80-byte rows
    (7, 13, 40, F32, True, ("onepass", 2)),
    (16, 196, 1024, F32, True, ("direct", 1)),  # more than 128 vectors per row
    (256, 196, 2048, BF16, True, ("direct", 1)),
    (5, 13, 36, BF16, True, ("direct", 1)),  # 72-byte rows
    (5, 13, 30, F32, True, ("direct", 1)),
    (256, 196, 512, BF16, False, ("direct", 1)),  # a misaligned operand
]


@pytest.mark.parametrize("B,L,D,dtype,aligned,want", ROW_PLANS)
def test_attention_plan(B, L, D, dtype, aligned, want):
    es = torch.tensor([], dtype=dtype).element_size()
    design, C, threads = tfa.attention_plan(B, L, D, es, aligned)
    assert (design, C) == want and design in tfa.ATTENTION_DESIGNS
    assert threads % 32 == 0 and 32 <= threads <= 256
    assert 1 <= C <= tfa._CLUSTER_MAX
    if design == "onepass":
        assert tfa.onepass_smem_bytes(L, D, C, threads, es) <= tfa.SMEM_LIMIT
        assert -(-L // C) * (C - 1) < L or C == 1  # every block but the last has rows


def test_blocks_per_image():
    """One block per image once the batch fills the card, else the fewest
    that do, within the cap and the rows."""
    for B in range(1, 400, 3):
        for L in (1, 13, 196, 197, 4096):
            S = tfa.blocks_per_image(B, L, 8, 8)
            assert 1 <= S <= min(8, -(-L // 8))
            if B >= tfa.H100_SMS:
                assert S == 1
            elif S < min(8, -(-L // 8)):
                assert B * S >= tfa.H100_SMS > B * (S - 1)


@pytest.mark.parametrize("K", [1, 3, 8])
@pytest.mark.parametrize("L,D,dtype,aligned,want", [
    (196, 512, BF16, True, ("stream", 7)),
    (196, 512, F32, True, ("stream", 7)),
    (1, 512, BF16, True, ("stream", 1)),
    (13, 512, BF16, True, ("stream", 1)),
    (197, 512, BF16, True, ("stream", 8)),
    (196, 1000, BF16, True, ("stream", 7)),
    (196, 1024, BF16, True, ("stream", 7)),
    (196, 1024, F32, True, ("direct", 1)),
    (13, 36, BF16, True, ("direct", 1)),
    (196, 512, BF16, False, ("direct", 1)),
])
def test_scores_plan(K, L, D, dtype, aligned, want):
    es = torch.tensor([], dtype=dtype).element_size()
    design, S, threads = tfda.scores_plan(K, L, D, es, aligned)
    assert (design, S) == want and design in tfda.SCORE_DESIGNS
    assert threads % 32 == 0 and 32 <= threads <= 256
    if design == "stream":
        assert tfda.scores_smem_bytes(K, D, es, threads) <= tfda.SMEM_LIMIT
        # hp stays in registers while its K * NV vectors per lane are at most 8
        nv = tfa.row_vectors(D, es)
        ring = (threads // 32) * (4 if nv == 4 else 8) * nv * 512
        assert (tfda.scores_smem_bytes(K, D, es, threads) == ring) == (K * nv <= 8)


def test_streaming_plans_match_the_sources():
    """The planners' limits are the kernels'."""
    src = _source("additive_attention.cu")
    assert f"ONEPASS_CMAX = {tfa._CLUSTER_MAX};" in src
    assert f"ONEPASS_NT_MAX = {tfa._ONEPASS_THREADS};" in src
    assert f"D > {tfa._ONEPASS_NV_MAX} * 32 * VEC" in src
    assert f"constexpr int P = {tfa._ONEPASS_STAGES};" in src
    # onepass_smem_bytes: the ring (512 bytes per vector of 32 lanes), then the merge area
    assert "return (size_t)NW * P * 2 * NV * 32 * 4 + (size_t)NW * D + D + 4 + 2 * 32 + Lc;" in src
    src = _source("beam_attention.cu")
    assert f"D > {tfda._STREAM_NV_MAX} * 32 * VEC" in src
    assert "HP_REGS = K * NV <= 8" in src and "K * NV <= 8 ? 0 : (size_t)K * D * sizeof(T)" in src
    assert "stream_stages(int NV) { return NV == 4 ? 4 : 8; }" in src  # scores_smem_bytes' ring


def onepass_merge(e, f, C, NW):
    """numpy fp32 emulation of the one-pass kernel's softmax and context for
    one image: scores e [L], features f [L, D], the rows split over C blocks
    of NW warps, each warp folding its rows under a running max and sum of
    exp, then the warps and the blocks merged by their weights."""
    f32 = np.float32
    L = len(e)
    Lc = -(-L // C)
    blocks = []
    for r in range(C):
        rows = range(r * Lc, min(L, (r + 1) * Lc))
        warps = []
        for w in range(NW):
            m, s, acc = f32(-np.inf), f32(0), np.zeros(f.shape[1], f32)
            for l in list(rows)[w::NW]:
                if e[l] > m:
                    scale = np.exp(m - e[l], dtype=f32)
                    s, acc, m = s * scale, acc * scale, e[l]
                p = np.exp(e[l] - m, dtype=f32)
                s, acc = s + p, acc + p * f[l]
            warps.append((m, s, acc))
        mb = max(m for m, _, _ in warps)
        wg = [np.exp(m - mb, dtype=f32) if s > 0 else f32(0) for m, s, _ in warps]
        blocks.append((mb, sum(s * g for (_, s, _), g in zip(warps, wg)),
                       sum(a * g for (_, _, a), g in zip(warps, wg))))
    mg = max(m for m, _, _ in blocks)
    wq = [np.exp(m - mg, dtype=f32) if s > 0 else f32(0) for m, s, _ in blocks]
    sg = sum(s * g for (_, s, _), g in zip(blocks, wq))
    ctx = sum(a * g for (_, _, a), g in zip(blocks, wq)) / sg / f32(L)
    return ctx.astype(f32), (np.exp(e - mg, dtype=f32) / sg).astype(f32)


@pytest.mark.parametrize("L,C,NW", [(196, 2, 8), (196, 4, 8), (197, 3, 8), (13, 1, 8), (1, 1, 8),
                                    (5, 4, 4), (196, 8, 4)])
def test_onepass_merge_matches_the_plain_softmax(L, C, NW):
    """The running max / sum of exp and its two merges give the plain
    version's alpha and context within the fp32 limits the card run holds
    (2e-5 absolute, 1e-5 of the output's scale), also with scores that rise,
    fall, repeat and span 60 units, and with blocks and warps that get no
    row."""
    rng = np.random.default_rng(L * 100 + C)
    D = 24
    f = rng.standard_normal((L, D)).astype(np.float32)
    cases = [rng.standard_normal(L) * 3, np.linspace(-30, 30, L), np.linspace(30, -30, L), np.zeros(L)]
    for e in cases:
        e = e.astype(np.float32)
        ctx, alpha = onepass_merge(e, f, C, NW)
        ra = torch.softmax(torch.from_numpy(e), dim=-1)
        rc = (ra[:, None] * torch.from_numpy(f)).sum(0) / L
        for got, want in ((ctx, rc.numpy()), (alpha, ra.numpy())):
            assert np.isfinite(got).all()
            assert np.abs(got - want).max() <= min(2e-5, 1e-5 * np.abs(want).max())
        assert abs(alpha.sum() - 1) <= 1e-5


def tanh_ex2(x, ex2_err=0.0, rcp_err=0.0):
    """numpy fp32 emulation of the kernel's fp32 tanh, 1 - 2 / (1 + 2^(2x
    log2 e)), with ex2.approx and rcp.approx perturbed by a relative error."""
    x = np.asarray(x, np.float32)
    one = np.float32(1)
    with np.errstate(over="ignore"):
        t = np.exp2((x * np.float32(2.8853900817779268)).astype(np.float32)).astype(np.float32)
        t = (t * np.float32(1 + ex2_err)).astype(np.float32)
        r = (one / (one + t)).astype(np.float32)
        r = (r * np.float32(1 + rcp_err)).astype(np.float32)
    return (one - np.float32(2) * r).astype(np.float32)


def test_ex2_tanh_error_bound():
    """Over [-30, 30], 0, +-inf and large |x|: no NaN, the ends exact, and
    within TANH_EX2_BOUND of tanh, also with ex2.approx off by 2^-22 and
    rcp.approx by 2^-23 (their PTX error bounds) either way."""
    specials = np.array([0.0, -0.0, np.inf, -np.inf, 1e30, -1e30, 88.0, -88.0, 1e-30], np.float32)
    x = np.concatenate([np.linspace(-30, 30, 600_001, dtype=np.float32), specials])
    ref = np.tanh(x.astype(np.float64))
    for e1 in (-2.0 ** -22, 0.0, 2.0 ** -22):
        for e2 in (-2.0 ** -23, 0.0, 2.0 ** -23):
            y = tanh_ex2(x, e1, e2)
            assert not np.isnan(y).any()
            assert np.abs(y - ref).max() <= TANH_EX2_BOUND, (e1, e2)
    y = tanh_ex2(specials)
    assert y[0] == 0 and y[2] == 1 and y[3] == -1 and y[4] == 1 and y[5] == -1


def test_launch_counts_by_design():
    cuda_lib.LAUNCHES.clear()
    cuda_lib.count("lstm_cell", "wgmma")
    cuda_lib.count("lstm_cell", "wgmma")
    cuda_lib.count("lstm_cell", "tiled")
    assert cuda_lib.LAUNCHES["lstm_cell"] == 3
    assert cuda_lib.designs("lstm_cell") == {"wgmma": 2, "tiled": 1}
    assert cuda_lib.designs("attention_beam") == {}
    cuda_lib.LAUNCHES.clear()
