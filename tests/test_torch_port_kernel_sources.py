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
from show_and_tell_tpu_torch.ops import tanh_probe as tprobe

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
    (1, 1024, 1024, BF16, True, ("skinny", 8)),  # a batch-1 client: the small-batch form
    (4, 1000, 1000, BF16, True, ("skinny", 8)),  # ragged H and k-tiles on TMA
    (13, 40, 24, BF16, True, ("skinny", 16)),
    (9, 48, 40, BF16, True, ("skinny", 16)),
    (5, 17, 20, BF16, True, ("tiled", 64)),  # I not a multiple of 8
    (256, 1024, 1024, BF16, False, ("tiled", 64)),  # a misaligned operand
    # fp32, the Config default: the 3xTF32 design wherever TMA takes the shape
    (768, 1024, 1024, F32, True, ("tf32x3", 64)),  # beam-3 serving
    (256, 1024, 1024, F32, True, ("tf32x3", 64)),  # greedy, the first beam step, training
    (768, 512, 1024, F32, True, ("tf32x3", 64)),  # Show-and-Tell's layer 0
    (256, 512, 1024, F32, True, ("tf32x3", 64)),
    (300, 1024, 1024, F32, True, ("tf32x3", 64)),
    (1, 1024, 1024, F32, True, ("skinny", 8)),
    (64, 1000, 1000, F32, True, ("tf32x3", 64)),  # ragged H and k-tiles on TMA
    (13, 40, 24, F32, True, ("skinny", 16)),
    (5, 17, 20, F32, True, ("tiled", 64)),  # I not a multiple of 4
    (9, 48, 42, F32, True, ("tiled", 64)),  # H not a multiple of 4
    (256, 1024, 1024, F32, False, ("tiled", 64)),  # a misaligned operand
    (4, 0, 8, F32, True, ("tiled", 64)),
    # the serving front door's batches (the Captioner's buckets 1, 8, 32,
    # 128; B=1 above)
    (8, 1024, 1024, BF16, True, ("skinny", 8)),
    (32, 1024, 1024, BF16, True, ("skinny", 32)),
    (128, 1024, 1024, BF16, True, ("mcast", 64)),  # between the regimes: the cluster form
    (8, 1024, 1024, F32, True, ("skinny", 8)),
    (32, 1024, 1024, F32, True, ("skinny", 32)),
    (128, 1024, 1024, F32, True, ("tf32x3", 64)),
    (64, 1024, 1024, BF16, True, ("skinny", 64)),  # the crossovers and one above
    (65, 1024, 1024, BF16, True, ("mcast", 64)),
    (96, 1024, 1024, BF16, True, ("mcast", 64)),  # beam-3 at bucket 32
    (96, 512, 1024, BF16, True, ("mcast", 64)),  # Show-and-Tell's layer 0
    (127, 1024, 1024, BF16, True, ("mcast", 64)),
    (192, 1024, 1024, BF16, True, ("mcast", 64)),  # the eval driver's beam: 3 x 64
    (193, 1024, 1024, BF16, True, ("wgmma", 64)),
    (128, 1000, 1000, BF16, True, ("mcast", 64)),  # ragged H and k-tiles on TMA
    (70, 40, 40, BF16, True, ("mcast", 64)),
    (96, 1024, 1024, BF16, False, ("tiled", 64)),  # a misaligned operand
    (96, 17, 24, BF16, True, ("tiled", 64)),  # I not a multiple of 8
    (64, 1024, 1024, F32, True, ("tf32x3", 64)),  # fp32 has no middle form
    (65, 1024, 1024, F32, True, ("tf32x3", 64)),
    (96, 1024, 1024, F32, True, ("tf32x3", 64)),
    (127, 1024, 1024, F32, True, ("tf32x3", 64)),
    (192, 1024, 1024, F32, True, ("tf32x3", 64)),
    (32, 512, 1024, F32, True, ("skinny", 32)),
    (33, 512, 1024, F32, True, ("tf32x3", 64)),
    (24, 512, 1024, F32, True, ("skinny", 32)),  # Show-and-Tell's layer 0, beam at bucket 8
    (8, 1024, 1024, F32, False, ("tiled", 64)),  # a misaligned operand
])
def test_cell_design(B, I, H, dtype, aligned, want):
    assert tlstm.cell_design(B, I, H, dtype, aligned) == want


def test_cell_tile_fills_the_card():
    """Three bf16 regimes by batch: up to ``SKINNY_MAX_B`` the small-batch
    form, with the smallest batch tile that holds B (64 past it); up to
    ``MCAST_MAX_B`` the cluster form, 64 rows; above it the wgmma tile,
    which takes the fewest rows of work per SM over the three tiles, for
    batches up to 1024; every design is a known name. fp32 has two: the
    small-batch form, then tf32x3."""
    crossover, middle = tlstm.SKINNY_MAX_B[BF16], tlstm.MCAST_MAX_B
    assert crossover < middle
    for B in range(1, 1025, 7):
        design, bm = tlstm.cell_design(B, 1024, 1024, BF16, True)
        assert design in tlstm.CELL_DESIGNS
        if B <= crossover:
            assert design == "skinny" and bm == min([t for t in (8, 16, 32, 64) if t >= B] or [64]), B
            continue
        if B <= middle:
            assert (design, bm) == ("mcast", tlstm._MCAST_BM), B
            continue
        assert design == "wgmma", B

        def rows_per_sm(t):
            return math.ceil(math.ceil(B / t) * 32 / tlstm.H100_SMS) * t

        assert rows_per_sm(bm) == min(rows_per_sm(t) for t in (64, 128, 192)), B
    for B in range(1, 1025, 7):
        design = tlstm.cell_design(B, 1024, 1024, F32, True)[0]
        assert design == ("skinny" if B <= tlstm.SKINNY_MAX_B[F32] else "tf32x3"), B
    for dtype in (BF16, F32):
        X = tlstm.SKINNY_MAX_B[dtype]
        assert tlstm.cell_design(X, 1024, 1024, dtype, True)[0] == "skinny"
        assert tlstm.cell_design(X + 1, 1024, 1024, dtype, True)[0] == ("mcast" if dtype == BF16 else "tf32x3")
    assert tlstm.cell_design(middle, 1024, 1024, BF16, True)[0] == "mcast"
    assert tlstm.cell_design(middle + 1, 1024, 1024, BF16, True)[0] == "wgmma"


def test_tf32x3_entry_matches_the_wrapper():
    """The 3xTF32 entry point is bound with the wrapper's arguments (seven
    pointers, B, I, H, the stream), and the source's tile is the planner's:
    one warpgroup of 64 rows by 32 columns of each gate."""
    src = _source("lstm_cell.cu")
    params = dict(_EXTERN.findall(src))["sat_lstm_cell_tf32x3"].split(",")
    assert len(params) == 11 and "wt" in params[2]
    assert cuda_lib._SIGNATURES["lstm_cell.cu"]["sat_lstm_cell_tf32x3"] == (
        (cuda_lib.ctypes.c_void_p,) * 7 + (cuda_lib.ctypes.c_int,) * 3 + (cuda_lib.ctypes.c_void_p,))
    t3 = src[src.index("namespace t3 {"):]
    assert f"constexpr int BM = {tlstm._TF32X3_BM};" in t3
    assert f"constexpr int BN = {tlstm._WGMMA_BN};" in t3
    assert "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32" in t3
    assert "cvt.rna.tf32.f32" in t3
    assert "tf32x3" in tlstm.CELL_DESIGNS


def test_skinny_entry_matches_the_wrapper():
    """The small-batch entry point is bound with the wrapper's arguments
    (seven pointers, B, I, H, the batch tile, the type, the stream), and
    the source's tile is the planner's (8 hidden columns of each gate, the
    batch tiles 8-64) and the emulation's (eight warps taking the 128-byte
    k-tiles in turn; bf16 on mma.sync m16n8k16, fp32 on fmaf)."""
    src = _source("lstm_cell.cu")
    params = dict(_EXTERN.findall(src))["sat_lstm_cell_skinny"].split(",")
    assert len(params) == 13 and "bt" in params[10] and "dtype" in params[11]
    assert cuda_lib._SIGNATURES["lstm_cell.cu"]["sat_lstm_cell_skinny"] == (
        (cuda_lib.ctypes.c_void_p,) * 7 + (cuda_lib.ctypes.c_int,) * 5 + (cuda_lib.ctypes.c_void_p,))
    sk = src[src.index("namespace sk {"):src.index("}  // namespace sk")]
    assert f"constexpr int BN = {tlstm._SKINNY_BN};" in sk
    assert f"constexpr int NW = {SKINNY_NW};" in sk
    assert f"constexpr int ROW = {4 * SKINNY_BK[F32]};" in sk and 2 * SKINNY_BK[BF16] == 4 * SKINNY_BK[F32]
    cases = [int(n) for n in re.findall(r"case (\d+): return launch<T, \1>", sk)]
    assert tuple(cases) == tlstm._SKINNY_BT
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in sk and "fmaf" in sk
    assert "skinny" in tlstm.CELL_DESIGNS


def test_mcast_entry_matches_the_wrapper():
    """The entry point between the regimes is bound with the wrapper's
    arguments (seven pointers, B, I, H, the stream-only flag, the stream),
    and the source's tile is the planner's: 64 batch rows by 64 hidden
    columns of one gate per block (one wgmma m64n64k16 per k16), a cluster
    of the four gates' blocks whose [x|h] tiles arrive by TMA multicast, a
    quarter issued by each, whose stages are handed back to every block of
    the cluster, and whose z tiles meet through distributed shared memory."""
    src = _source("lstm_cell.cu")
    params = dict(_EXTERN.findall(src))["sat_lstm_cell_mcast"].split(",")
    assert len(params) == 12 and params[10].split()[-1] == "stream_only"
    assert cuda_lib._SIGNATURES["lstm_cell.cu"]["sat_lstm_cell_mcast"] == (
        (cuda_lib.ctypes.c_void_p,) * 7 + (cuda_lib.ctypes.c_int,) * 4 + (cuda_lib.ctypes.c_void_p,))
    mc = src[src.index("namespace mc {"):src.index("}  // namespace mc")]
    assert f"constexpr int BM = {tlstm._MCAST_BM};" in mc
    assert f"constexpr int BN = {tlstm._MCAST_BN};" in mc
    assert f"constexpr int BK = {MCAST_BK};" in mc
    assert f"constexpr int GATES = {tlstm._MCAST_GATES};" in mc
    assert "constexpr int AROWS = BM / GATES;" in mc
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in mc
    assert ".multicast::cluster" in mc and "mbarrier.arrive.shared::cluster" in mc
    assert "attr[0].val.clusterDim.x = GATES;" in mc and "mapa.u64" in mc
    assert "mcast" in tlstm.CELL_DESIGNS


@pytest.mark.parametrize("B,H,blocks", [
    (65, 1024, 128),  # one row past the small-batch form: two row blocks
    (96, 1024, 128),  # beam-3 at bucket 32
    (128, 1024, 128),  # greedy at bucket 128, the training batch
    (128, 512, 64),
    (192, 1024, 192),  # the eval driver's beam: three row blocks
    (tlstm.MCAST_MAX_B, 1024, 192),
    (70, 40, 8),  # one cluster of 64 columns, H=40 of them real
])
def test_mcast_grid_fills_the_card_in_one_wave(B, H, blocks):
    """The mcast grid: 4 x H / 64 blocks per row block of 64, clusters of
    four; up to the crossover the clusters of H=1024 (32 at B = 65-128, 48
    at 129-192) fit the 62 that two blocks per SM allow at once (30 with
    one: the reason for two)."""
    per_row = tlstm._MCAST_GATES * -(-H // tlstm._MCAST_BN)
    assert per_row % tlstm._MCAST_GATES == 0  # the cluster divides the grid
    assert -(-B // tlstm._MCAST_BM) * per_row == blocks
    assert blocks <= 2 * tlstm.H100_SMS and blocks // tlstm._MCAST_GATES <= 62


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


# --- the (image, beam) grid and the transposed form (rows 4 and 5) ------------


@pytest.mark.parametrize("B,K,L,D,dtype,aligned,want", [
    (256, 3, 196, 512, BF16, True, ("onepass", 1)),  # serving: 768 rows fill the card
    (256, 3, 196, 512, F32, True, ("onepass", 1)),
    (64, 8, 196, 512, BF16, True, ("onepass", 1)),
    (256, 1, 196, 512, BF16, True, ("onepass", 1)),  # K=1: the per-row attention
    (1, 3, 196, 512, BF16, True, ("onepass", 8)),
    (16, 3, 196, 1000, BF16, True, ("onepass", 3)),  # 48 rows: 3 blocks each
    (256, 3, 13, 512, BF16, True, ("onepass", 1)),
    (5, 3, 13, 36, BF16, True, ("direct", 1)),  # 72-byte rows
    (16, 3, 196, 1024, F32, True, ("direct", 1)),  # more than 128 vectors per row
    (256, 3, 196, 512, BF16, False, ("direct", 1)),  # a misaligned operand
])
def test_grid2_plan(B, K, L, D, dtype, aligned, want):
    """The grid runs the per-row attention's plan over its B * K rows."""
    es = torch.tensor([], dtype=dtype).element_size()
    design, C, threads = tfda.grid2_plan(B, K, L, D, es, aligned)
    assert (design, C) == want
    assert (design, C, threads) == tfa.attention_plan(B * K, L, D, es, aligned)


def _st_cost(K, L, D, C, es):
    """The planner's cost of C blocks per image, or None where C cannot run."""
    ve = 8 // es
    nvec = L // ve
    vc = -(-nvec // C)
    if vc > 32 or (C - 1) * vc >= nvec or tfda.st_smem_bytes(K, L, D, C, es) > tfda.SMEM_LIMIT:
        return None
    rows = -(-D // 8)  # rows of ce^T per warp
    return C * -(-rows // (32 // vc))


@pytest.mark.parametrize("K,L,D,dtype,aligned,want", [
    (3, 196, 512, BF16, True, ("cluster", 5)),  # serving: 10 vectors of l per block
    (1, 196, 512, BF16, True, ("cluster", 5)),
    (8, 196, 512, BF16, True, ("cluster", 5)),
    (3, 196, 1000, BF16, True, ("cluster", 5)),
    (8, 196, 1024, BF16, True, ("cluster", 5)),
    (3, 196, 512, F32, True, ("cluster", 7)),  # 98 vectors of two fp32
    (3, 196, 1024, F32, True, ("cluster", 7)),
    (3, 64, 512, BF16, True, ("cluster", 1)),
    (2, 200, 64, BF16, True, ("cluster", 7)),
    (3, 4, 512, BF16, True, ("cluster", 1)),  # one vector of l
    (3, 13, 512, BF16, True, ("direct", 1)),  # 26-byte rows of ce^T
    (3, 197, 512, BF16, True, ("direct", 1)),
    (3, 1, 512, BF16, True, ("direct", 1)),
    (3, 13, 36, F32, True, ("direct", 1)),
    (3, 196, 36, BF16, True, ("direct", 1)),  # 72-byte rows of f
    (3, 196, 512, BF16, False, ("direct", 1)),  # a misaligned operand
])
def test_st_plan(K, L, D, dtype, aligned, want):
    """The cluster that costs fewest warp steps, the smaller on a tie, every
    block with rows and within shared memory; rows that are not 8-byte
    multiples of ce^T or 16-byte multiples of f take the first kernel."""
    es = torch.tensor([], dtype=dtype).element_size()
    design, C = tfda.st_plan(K, L, D, es, aligned)
    assert (design, C) == want and design in tfda.ST_DESIGNS
    if design == "cluster":
        costs = {c: _st_cost(K, L, D, c, es) for c in range(1, tfda._ST_CLUSTER_MAX + 1)}
        costs = {c: v for c, v in costs.items() if v is not None}
        assert costs[C] == min(costs.values()) and C == min(c for c, v in costs.items() if v == costs[C])


def test_st_smem_layout_matches_the_source():
    """The planner's layout constants and formula are the kernel's."""
    src = _source("beam_attention.cu")
    assert f"ST_CMAX = {tfda._ST_CLUSTER_MAX};" in src
    assert f"ST_P = {tfda._ST_STAGES};" in src
    assert f"ST_U = {tfda._ST_VECS};" in src
    assert f"ST_BAR = {tfda._ST_BAR_BYTES};" in src
    assert f"NT = {tfda._ST_THREADS};" in src
    assert "const size_t ring = (size_t)NW * ST_P * ST_U * 32 * 8;" in src
    assert "red = sizeof(float) * NW * K * Lc, part = sizeof(float) * K * D;" in src
    assert ("return ST_BAR + (size_t)Lc * D * es + st_reuse_bytes(K, Lc, D) + (size_t)(K + 1) * D * es +\n"
            "         sizeof(float) * ((size_t)K * Lc + 2 * K + (size_t)K * ST_CMAX);") in src
    # 8-byte vectors of l, at most 32 per block
    assert "constexpr int VE = 8 / sizeof(T);" in src and "Vc > 32" in src


def st_split(ce, f, hp, w, C, NW=8):
    """numpy fp32 emulation of the transposed form's cluster kernel for one
    image: ce, f [L, D], hp [K, D], w [D]; block r of C takes a slice of 8-byte
    vectors of l (4 patches), its warps the partial scores over D / NW rows
    of ce^T each, summed in shared memory; the block's max and sum of exp
    and its partial context; then the blocks merged by exp(m_q - m) / s."""
    f32 = np.float32
    L, D = ce.shape
    K = hp.shape[0]
    ve = 4
    nvec = L // ve
    vc = -(-nvec // C)
    dw = -(-D // NW)
    blocks = []
    for r in range(C):
        l0, nl = r * vc * ve, max(0, min(nvec, (r + 1) * vc) - r * vc) * ve
        rows = slice(l0, l0 + nl)
        e = np.zeros((K, nl), f32)
        for wp in range(NW):
            d = slice(min(D, wp * dw), min(D, wp * dw + dw))
            t = np.tanh(ce[rows, None, d] + hp[None, :, d]).astype(f32)  # [nl, K, dw]
            e += (t * w[d]).sum(-1, dtype=f32).T
        m = e.max(1) if nl else np.full(K, -np.inf, f32)
        p = np.exp(e - m[:, None], dtype=f32)
        blocks.append((l0, nl, m, p.sum(1, dtype=f32), p, (p @ f[rows]).astype(f32)))
    mg = np.max([m for _, _, m, _, _, _ in blocks], axis=0)
    wq = [np.where(s > 0, np.exp(np.where(s > 0, m - mg, 0), dtype=f32), 0).astype(f32)
          for _, _, m, s, _, _ in blocks]
    sg = sum(s * g for (_, _, _, s, _, _), g in zip(blocks, wq))
    ctx = sum((g / sg)[:, None] * part for (*_, part), g in zip(blocks, wq)) / f32(L)
    alpha = np.zeros((K, L), f32)
    for (l0, nl, _, _, p, _), g in zip(blocks, wq):
        alpha[:, l0:l0 + nl] = p * (g / sg)[:, None]
    return ctx.astype(f32), alpha


@pytest.mark.parametrize("L,D,K,C", [(196, 64, 3, 5), (196, 64, 1, 4), (200, 24, 2, 7), (64, 32, 3, 1),
                                     (4, 16, 8, 1), (20, 16, 3, 4), (196, 40, 3, 8)])
def test_st_split_matches_the_plain_softmax(L, D, K, C):
    """The transposed form's split (partial scores over D slices, each
    block's max and sum of exp and partial context, the cluster's
    running-softmax merge) gives the plain version's alpha and context within
    the fp32 limits the card run holds (2e-5 absolute, 1e-5 of the output's
    scale), also with a block that gets no row (L=20, C=4) and with scores
    spread wide."""
    rng = np.random.default_rng(L * 10 + C)
    for scale in (1.0, 8.0):
        ce = (rng.standard_normal((L, D)) * scale).astype(np.float32)
        f = rng.standard_normal((L, D)).astype(np.float32)
        hp = rng.standard_normal((K, D)).astype(np.float32)
        w = (rng.standard_normal(D) * scale).astype(np.float32)
        ctx, alpha = st_split(ce, f, hp, w, C)
        # the reference in float64 throughout: an fp32 reference's own
        # rounding of the scores (in a reduction order that torch picks by
        # thread count and kernel path) takes up to a quarter of the limit
        ce64, hp64, w64 = (torch.from_numpy(a).double() for a in (ce, hp, w))
        e = torch.einsum("lkd,d->kl", torch.tanh(ce64[:, None] + hp64[None]), w64)
        ra = torch.softmax(e, dim=-1)
        rc = (ra @ torch.from_numpy(f).double()) / L
        for got, want in ((ctx, rc.numpy()), (alpha, ra.numpy())):
            assert np.isfinite(got).all()
            assert np.abs(got - want).max() <= min(2e-5, 1e-5 * np.abs(want).max())
        assert np.abs(alpha.sum(1) - 1).max() <= 1e-5


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


def tanh_poly_source():
    """(clamp, coefficients from x^1 up) of the polynomial tanh in
    csrc/sat_common.cuh, read from the source."""
    src = _source("sat_common.cuh")
    bits = int(re.search(r"TANH_POLY_CLAMP_BF16X2 = 0x([0-9A-Fa-f]{8})u", src).group(1), 16)
    assert bits >> 16 == bits & 0xFFFF  # the same clamp in both halves
    clamp = float(np.array([(bits & 0xFFFF) << 16], np.uint32).view(np.float32)[0])
    body = re.search(r"float tanh_poly_f32\(float x\) \{(.*?)\n\}", src, re.S).group(1)
    top = re.search(r"float p = ([-+0-9.e]+)f;", body).group(1)
    rest = re.findall(r"p = fmaf\(p, x2, ([-+0-9.e]+)f\);", body)
    assert "return x * p;" in body
    return clamp, [np.float32(c) for c in reversed([top, *rest])]


def _bf16(v):
    """fp32 -> bf16 (round to nearest even) -> fp32."""
    return torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16).float().numpy()


def tanh_poly(x):
    """numpy fp32 emulation of `sat::tanh_poly_bf16x2` on bf16 inputs given
    as fp32: min.NaN.xorsign.abs with the clamp, x^2 and x * P in fp32, P by
    Horner's rule with fmaf (emulated in float64, where the product is exact;
    the sum is rounded twice, which can move an fp32 result by one unit only
    on an fp32 midpoint), the result rounded to bf16."""
    clamp, coeffs = tanh_poly_source()
    x = np.asarray(x, np.float32)
    with np.errstate(invalid="ignore"):
        xc = np.where(np.isnan(x), np.float32(np.nan), np.copysign(np.minimum(np.abs(x), np.float32(clamp)), x))
        xc = xc.astype(np.float32)
        x2 = (xc.astype(np.float64) ** 2).astype(np.float32)
        p = np.full_like(x2, coeffs[-1])
        for c in coeffs[-2::-1]:
            p = (p.astype(np.float64) * x2 + np.float64(c)).astype(np.float32)
        return _bf16((xc.astype(np.float64) * p).astype(np.float32))


def _every_bf16():
    return (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)


def _bf16_order(v):
    """bf16 values as integers in their order (adjacent values differ by 1)."""
    b = torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16).view(torch.int16).numpy().astype(np.int64)
    return np.where(b < 0, -(b & 0x7FFF), b)


def test_tanh_poly_within_one_bf16_step():
    """Every finite bf16 input (all 65,280 of the 65,536 bit patterns):
    the polynomial tanh within one bf16 step of tanh in float64 rounded to
    bf16. And its degree is the least: with one coefficient fewer (one FMA
    less) no odd polynomial, even one evaluated exactly, keeps every bf16
    input from 2^-14 to the clamp within one step (a linear program over
    those inputs finds no slack)."""
    from scipy.optimize import linprog

    x = _every_bf16()
    x = x[np.isfinite(x)]
    assert x.size == 65280
    steps = np.abs(_bf16_order(tanh_poly(x)) - _bf16_order(_bf16(np.tanh(x.astype(np.float64)))))
    assert steps.max() <= 1
    clamp, coeffs = tanh_poly_source()
    assert len(coeffs) == 7  # six FMAs
    grid = x[(x >= 2.0 ** -14) & (x <= clamp)].astype(np.float64)

    def value(order):  # positive bf16 with these order numbers, as float64
        return (np.asarray(order, np.uint32) << 16).view(np.float32).astype(np.float64)

    ref = _bf16_order(_bf16(np.tanh(grid)))
    top = _bf16_order(np.float32(1.0))
    lo = (value(ref - 2) + value(ref - 1)) / 2  # the output rounds to ref - 1 or above ...
    hi = (value(np.minimum(ref + 1, top)) + value(np.minimum(ref + 1, top) + 1)) / 2  # ... to ref + 1 or below
    step = value(ref + 1) - value(ref)
    A = np.stack([grid ** (2 * k + 1) for k in range(len(coeffs) - 1)], 1)
    # maximize s with lo + s step <= A a <= hi - s step
    res = linprog(np.r_[np.zeros(A.shape[1]), -1.0],
                  A_ub=np.vstack([np.hstack([-A, step[:, None]]), np.hstack([A, step[:, None]])]),
                  b_ub=np.concatenate([-lo, hi]), bounds=[(None, None)] * (A.shape[1] + 1), method="highs")
    assert res.status == 0 and -res.fun < 0


def test_tanh_poly_is_odd_and_saturates():
    """Odd bit for bit; |tanh| <= 1 everywhere; exactly +-1 from the clamp
    on, for +-inf, and at no input where the correctly rounded tanh is not
    within a step of 1; the clamp is the first bf16 at or past atanh(1 -
    2^-9), from where the correctly rounded bf16 tanh is 1."""
    x = _every_bf16()
    x = x[~np.isnan(x)]
    y = tanh_poly(x)
    assert np.array_equal(tanh_poly(-x), -y)
    assert np.abs(y).max() == 1.0
    clamp, _ = tanh_poly_source()
    assert np.all(np.abs(y[np.abs(x) >= clamp]) == 1.0)
    assert list(tanh_poly(np.array([np.inf, -np.inf], np.float32))) == [1.0, -1.0]
    edge = np.arctanh(1 - 2.0 ** -9)
    positive = np.sort(x[x > 0])
    assert clamp == positive[positive >= edge][0]
    assert _bf16(np.tanh(np.float64(clamp))) == 1.0
    assert _bf16(np.tanh(np.float64(positive[positive < clamp][-1]))) < 1.0


def test_tanh_poly_keeps_nan():
    """A NaN (every NaN bit pattern, either sign) gives a NaN, where an
    fminf/fmaxf clamp would give the clamp's tanh."""
    x = _every_bf16()
    nan = x[np.isnan(x)]
    assert nan.size == 2 * 127
    assert np.isnan(tanh_poly(nan)).all()


def test_tanh_forms_follow_the_kernel_enum():
    """TANH_FORMS lists the kernel's `Form` in its order (the wrapper passes
    the index), and the bf16-only forms are the ones the source launches for
    bfloat16 alone."""
    src = _source("tanh_probe.cu")
    enum = re.search(r"enum Form \{([^}]*)\}", src).group(1)
    entries = [(name.strip(), int(v)) for name, v in re.findall(r"(\w+) = (\d+)", enum)]
    assert [v for _, v in entries] == list(range(len(entries)))
    assert tuple(name.lower() for name, _ in entries) == tprobe.TANH_FORMS
    fp32_cases = re.search(r"if \(dtype == 0\) \{(.*?)\n  \}", src, re.S).group(1)
    bf16_cases = re.search(r"if \(dtype == 1\) \{(.*?)\n  \}", src, re.S).group(1)
    fp32 = {n.lower() for n in re.findall(r"case (\w+):", fp32_cases)}
    bf16 = {n.lower() for n in re.findall(r"case (\w+):", bf16_cases)}
    assert bf16 == set(tprobe.TANH_FORMS)
    assert set(tprobe.BF16_ONLY) == bf16 - fp32
    assert set(tprobe.DEFAULT_FORM.values()) <= set(tprobe.TANH_FORMS)
    assert tprobe.DEFAULT_FORM[torch.float32] in fp32


def test_split_share_as_the_source_states_it():
    """split<P> sends P of a 16-byte vector's PAIRS pairs to the polynomial:
    SPLIT_SHARE is P / PAIRS by the source's enum and `poly_pairs`, and the
    split forms on 16-byte vectors launch the ring design."""
    src = _source("tanh_probe.cu")
    pairs = int(re.search(r"constexpr int PAIRS = (\d+);", src).group(1))
    assert pairs == 16 // 2 // 2  # bf16 pairs in 16 bytes
    assert "return FORM >= SPLIT0 ? FORM - SPLIT0 : 0;" in src
    first = int(re.search(r"SPLIT0 = (\d+)", src).group(1))
    splits = {name.lower(): int(v) - first for name, v in re.findall(r"(SPLIT\d) = (\d+)", src)}
    assert {f"split{p}" for p in splits.values()} == set(splits)
    assert tprobe.SPLIT_SHARE == {name: p / pairs for name, p in splits.items()}
    assert set(tprobe.SPLIT_SHARE) < set(tprobe.BF16_ONLY)
    assert "if (vec) return launch_ring<FORM>(" in src


def test_tanh_probe_split_forms_on_cpu():
    """On CPU tensors every form, the split ones included, is the plain
    version; an unknown form raises before any launch."""
    rng = np.random.default_rng(13)
    for dt in (torch.bfloat16, torch.float32):
        ce = torch.from_numpy(rng.standard_normal((2, 13, 40), dtype=np.float32)).to(dt)
        hp = torch.from_numpy(rng.standard_normal((2, 3, 40), dtype=np.float32)).to(dt)
        ref = tprobe.tanh_probe_reference(ce, hp)
        for form in tprobe.SPLIT_SHARE:
            assert torch.equal(tprobe.tanh_probe(ce, hp, form), ref)
        with pytest.raises(ValueError, match="unknown tanh form"):
            tprobe.tanh_probe(ce, hp, "split8")


def test_tanh_rate_plain_version_on_cpu():
    """The split forms' compute-only loop on CPU tensors is its plain
    version, which steps x in bf16 and sums the bf16 tanh of every step in
    fp32 (checked here against numpy); bad operands and forms raise."""
    rng = np.random.default_rng(7)
    x0 = torch.from_numpy(rng.standard_normal((256, 32), dtype=np.float32) * 0.5).to(torch.bfloat16)
    hp = torch.from_numpy(rng.standard_normal(8, dtype=np.float32) * 0.05).to(torch.bfloat16)
    ref = tprobe.tanh_rate_reference(x0, hp, 5)
    for form in tprobe.SPLIT_SHARE:
        assert torch.equal(tprobe.tanh_rate(x0, hp, 5, form), ref)
    x, want = x0.float().numpy(), np.zeros(256, np.float64)
    h = np.tile(hp.float().numpy(), 4)
    for _ in range(5):
        x = _bf16(x + h)
        want += _bf16(np.tanh(x.astype(np.float64))).sum(1)
    assert ref.dtype == torch.float32 and np.abs(ref.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    with pytest.raises(ValueError, match="unknown split form"):
        tprobe.tanh_rate(x0, hp, 5, "bf16x2")
    with pytest.raises(ValueError, match="multiple of 256"):
        tprobe.tanh_rate(x0[:100], hp, 5, "split1")
    with pytest.raises(ValueError, match="multiple of 256"):
        tprobe.tanh_rate(x0.float(), hp, 5, "split1")


def test_launch_counts_by_design():
    cuda_lib.LAUNCHES.clear()
    cuda_lib.count("lstm_cell", "wgmma")
    cuda_lib.count("lstm_cell", "wgmma")
    cuda_lib.count("lstm_cell", "tiled")
    assert cuda_lib.LAUNCHES["lstm_cell"] == 3
    assert cuda_lib.designs("lstm_cell") == {"wgmma": 2, "tiled": 1}
    assert cuda_lib.designs("attention_beam") == {}
    # the (image, beam) grid and the transposed form, by their plans' names
    for _ in range(20):
        cuda_lib.count("attention_beam_grid2", "onepass1")
        cuda_lib.count("attention_beam_st", "cluster5")
    cuda_lib.count("attention_beam_st", "direct")
    assert cuda_lib.LAUNCHES["attention_beam_grid2"] == 20 and cuda_lib.LAUNCHES["attention_beam_st"] == 21
    assert cuda_lib.designs("attention_beam_grid2") == {"onepass1": 20}
    assert cuda_lib.designs("attention_beam_st") == {"cluster5": 20, "direct": 1}
    design, C, _ = tfda.grid2_plan(256, 3, 196, 512, 2, True)
    assert f"{design}{C}" == "onepass1"
    assert "".join(map(str, tfda.st_plan(3, 196, 512, 2, True))) == "cluster5"
    cuda_lib.LAUNCHES.clear()


# --- the 3xTF32 product, emulated ---------------------------------------------
#
# The tf32x3 kernel's arithmetic in numpy: each operand split into big =
# rna(a) and small = rna(a - big) (cvt.rna.tf32.f32: 10 mantissa bits, ties
# away from zero); per k-step of 8 the products a_s*w_b, a_b*w_s, a_b*w_b, each
# an exact 8-term dot added to the stage's partial sum with the result rounded
# toward zero to fp32 (the tensor cores' accumulation, as a build with one
# running sum showed on the card: below); per stage of 32 a fresh
# partial, added to the total by a round-to-nearest fp32 add; the gates in
# fp32. W's parts come from the port's own ``tf32x3_weight``.


def _rna(a):
    a = np.asarray(a, np.float32)
    r = ((a.view(np.uint32).astype(np.uint64) + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)
    return np.where(np.isfinite(a), r, a)


def _container(a):
    """What the tensor core reads of a 32-bit container: its top 19 bits."""
    return (np.asarray(a, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _toward_zero(s):
    r = s.astype(np.float32)
    up = np.abs(r.astype(np.float64)) > np.abs(s)
    r[up] = np.nextafter(r[up], np.float32(0))
    return r


def emulate_tf32x3_z(a, wt, partials=True, split="rna"):
    """z = a @ W as the kernel forms it: a [B, K] fp32, wt [2, N, K] (W^T's
    big and small parts). ``partials=False`` runs one running sum over the
    whole k-loop; ``split`` "big_unrounded" hands the tensor core a's raw
    fp32 as its big part, "small_unrounded" leaves a's small part unrounded."""
    big = _rna(a)
    small = _rna(a - big)
    if split == "big_unrounded":
        big = _container(a)
    elif split == "small_unrounded":
        small = _container(a - big)
    ab, as_ = big.astype(np.float64), small.astype(np.float64)
    wb, ws = wt[0].T.astype(np.float64), wt[1].T.astype(np.float64)
    B, K = a.shape
    acc = np.zeros((B, wb.shape[1]), np.float32)
    total = np.zeros_like(acc)
    for k0 in range(0, K, 32):
        if partials:
            acc[:] = 0
        for kk in range(k0, min(k0 + 32, K), 8):
            sl = slice(kk, kk + 8)
            for x, w in ((as_, wb), (ab, ws), (ab, wb)):
                acc = _toward_zero(acc + x[:, sl] @ w[sl])
        if partials:
            total = total + acc
    return total if partials else acc


def gates(z, b, c, dtype):
    """(h', c') from z [B, 4n] and c [B, n] in ``dtype``."""
    n = c.shape[1]
    z = (z + b).astype(dtype)
    sig = lambda v: 1 / (1 + np.exp(-v))  # noqa: E731
    i, f, g, o = sig(z[:, :n]), sig(z[:, n:2 * n]), np.tanh(z[:, 2 * n:3 * n]), sig(z[:, 3 * n:])
    c_new = f * c.astype(dtype) + i * g
    return o * np.tanh(c_new), c_new


def emulate_tf32x3_cell(w, b, x, h, c, hidden=None, **kw):
    """The tf32x3 kernel's (h', c') on numpy fp32 inputs, at the hidden
    columns ``hidden`` (all by default)."""
    H = h.shape[1]
    hidden = np.arange(H) if hidden is None else hidden
    zc = np.concatenate([g * H + hidden for g in range(4)])
    wt = tlstm.tf32x3_weight(torch.from_numpy(w)).numpy()[:, zc]
    z = emulate_tf32x3_z(np.concatenate([x, h], 1), wt, **kw)
    return gates(z, b[zc], c[:, hidden], np.float32)


def _draw_cell(B, I, H, seed):
    """chip_smoke.py ``cell_inputs``' distributions, from numpy: W and b
    uniform in +-H^-0.5, x, h and c standard normal."""
    rng = np.random.default_rng(seed)
    k = H ** -0.5
    w = rng.uniform(-k, k, (I + H, 4 * H)).astype(np.float32)
    b = rng.uniform(-k, k, 4 * H).astype(np.float32)
    x, h, c = (rng.standard_normal(s).astype(np.float32) for s in ((B, I), (B, H), (B, H)))
    return w, b, x, h, c


def test_tf32_round_is_cvt_rna():
    """The port's TF32 rounding (W's split) is round to nearest, ties away
    from zero, to 10 mantissa bits: ties, signs, the carry into the exponent,
    inf and NaN, and random bits against the numpy model of the kernel's."""
    one = np.float32(1)
    cases = np.array([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -11 - 2 ** -23,
                      2 - 2 ** -23, 3.4e38, np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-40], np.float32)
    want = [1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10), one, 2.0]
    got = tlstm.tf32_round(torch.from_numpy(cases)).numpy()
    np.testing.assert_array_equal(got[:5], np.array(want, np.float32))
    np.testing.assert_array_equal(got, _rna(cases))
    bits = np.random.default_rng(0).integers(0, 2 ** 32, 100_000, dtype=np.uint64).astype(np.uint32)
    a = bits.view(np.float32)
    got = tlstm.tf32_round(torch.from_numpy(a.copy())).numpy()
    fin = np.isfinite(a)
    np.testing.assert_array_equal(got.view(np.uint32)[fin], _rna(a).view(np.uint32)[fin])
    assert np.isnan(got[np.isnan(a)]).all()
    assert not (got.view(np.uint32)[fin] & 0x1FFF).any()  # the low 13 bits, which wgmma drops, are 0


def test_tf32x3_weight_is_wt_split():
    """``tf32x3_weight``: [2, 4H, I+H], W^T's big part and the rounding of
    what is left, both exact in TF32, which sum to W^T within 2^-22 of it."""
    w = torch.from_numpy(_draw_cell(1, 12, 8, 0)[0])
    wt = tlstm.tf32x3_weight(w)
    assert wt.shape == (2, 32, 20) and wt.dtype == torch.float32 and wt.is_contiguous()
    big, small = wt[0].double(), wt[1].double()
    assert not (wt.numpy().view(np.uint32) & 0x1FFF).any()
    np.testing.assert_array_equal(wt[0].numpy(), _rna(w.t().numpy()))
    err = ((big + small) - w.t().double()).abs()
    assert bool((err <= 2.0 ** -22 * w.t().double().abs()).all())


# B=768 I=H=1024 (beam-3 serving) and I=512 (Show-and-Tell's layer 0); every
# 32nd hidden column of each gate: the kernel's blocks are independent
@pytest.mark.parametrize("B,I,H", [(768, 1024, 1024), (768, 512, 1024)])
def test_tf32x3_emulation_meets_the_cell_tolerance(B, I, H):
    """The 3xTF32 algorithm meets phase 3's limit (1e-5 absolute and of
    scale) against the float64 cell, and sits no farther from it than
    twice plain fp32 (a float32 matmul) does. One running sum over the
    k-loop does not meet it (a build with that design failed the limit on
    the card, as this model of the tensor cores' sums predicts), so the
    kernel sums each stage apart. Without the explicit rounding of big (the
    tensor core truncating a's raw fp32) the error is a hundred times the
    kernel's."""
    w, b, x, h, c = _draw_cell(B, I, H, 0)
    hidden = np.arange(0, H, 32)
    zc = np.concatenate([g * H + hidden for g in range(4)])
    a = np.concatenate([x, h], 1)
    h64, c64 = gates(a.astype(np.float64) @ w[:, zc].astype(np.float64), b[zc], c[:, hidden], np.float64)
    h32, c32 = gates(a @ w[:, zc], b[zc], c[:, hidden], np.float32)

    def err(hc):
        return max(np.abs(hc[0] - h64).max(), np.abs(hc[1] - c64).max())

    scale = max(np.abs(h64).max(), np.abs(c64).max())
    kernel = err(emulate_tf32x3_cell(w, b, x, h, c, hidden))
    plain = err((h32, c32))
    assert kernel <= 1e-5 and kernel / scale <= 1e-5, kernel
    assert kernel <= 2 * plain, (kernel, plain)
    running = err(emulate_tf32x3_cell(w, b, x, h, c, hidden, partials=False))
    assert running > 1e-5, running
    unrounded = err(emulate_tf32x3_cell(w, b, x, h, c, hidden, split="big_unrounded"))
    assert unrounded > 100 * kernel and unrounded > 1e-4, (unrounded, kernel)


def test_tf32x3_split_covers_fp32():
    """Per element, big + small stands for a within 2^-23 |a|: big holds 11
    of fp32's 24 significant bits, and a - big, at most half a TF32 step,
    holds at most 12, of which small keeps 11. The one bit small drops is a
    tie, so its truncation by the tensor core would miss by as much as the
    rounding does. Big's rounding is the one that matters: handed a's raw
    fp32, the tensor core reads it truncated (a whole TF32 step under big
    where big rounded up), and the pair misses by up to 2^-10 |a|."""
    a = np.random.default_rng(1).standard_normal(200_000).astype(np.float32)
    big = _rna(a)

    def rel(b, small):
        return (np.abs(b.astype(np.float64) + small - a) / np.abs(a)).max()

    assert rel(big, _rna(a - big)) <= 2.0 ** -23
    assert rel(big, _container(a - big)) <= 2.0 ** -23
    assert 2.0 ** -11 < rel(_container(a), _rna(a - big)) <= 2.0 ** -10


# --- the small-batch form, emulated ------------------------------------------
#
# The skinny kernel's arithmetic in numpy: [x|h] in k-tiles of 128 bytes (64
# bf16 or 32 fp32; x's tiles, then h's), tile kt summed by warp kt % 8 into
# its own partial z; fp32 by one fmaf per (k, row) in k order, bf16 by one
# mma.sync per 16 k, an exact 16-term dot added to the warp's partial with
# the result rounded toward zero to fp32 (the tensor cores' accumulation,
# as the tf32x3 emulation models it); then the eight partials added in warp
# order, the bias, the gates in fp32.

SKINNY_NW = 8
SKINNY_BK = {F32: 32, BF16: 64}


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def emulate_skinny_z(x, h, w, dtype):
    """z = [x, h] @ W as the skinny kernel forms it: x [B, I], h [B, H], W
    [I + H, N] (columns of z) fp32 arrays holding values of ``dtype``."""
    B, I = x.shape
    bk = SKINNY_BK[dtype]
    tiles = [(x[:, k:k + bk], w[k:min(k + bk, I)]) for k in range(0, I, bk)]
    tiles += [(h[:, k:k + bk], w[I + k:I + k + bk]) for k in range(0, h.shape[1], bk)]
    parts = np.zeros((SKINNY_NW, B, w.shape[1]), np.float32)
    for kt, (a, wt) in enumerate(tiles):
        a64, w64 = a.astype(np.float64), wt.astype(np.float64)
        p = parts[kt % SKINNY_NW]
        if dtype == BF16:
            for j in range(0, a.shape[1], 16):
                p = _toward_zero(p + a64[:, j:j + 16] @ w64[j:j + 16])
        else:
            for j in range(a.shape[1]):  # fmaf: the exact product, one rounding of the sum
                p = (p + a64[:, j:j + 1] * w64[j]).astype(np.float32)
        parts[kt % SKINNY_NW] = p
    z = np.zeros((B, w.shape[1]), np.float32)
    for p in parts:
        z = (z + p).astype(np.float32)
    return z


def emulate_skinny_cell(w, b, x, h, c, dtype, hidden=None):
    """The skinny kernel's (h' before its rounding to h's type, c') at the
    hidden columns ``hidden`` (all by default), fp32."""
    H = h.shape[1]
    hidden = np.arange(H) if hidden is None else hidden
    zc = np.concatenate([g * H + hidden for g in range(4)])
    z = emulate_skinny_z(x, h, w[:, zc], dtype)
    return gates(z, b[zc], c[:, hidden], np.float32)


# the serving front door's batches at I=1024 and Show-and-Tell's I=512, every
# 32nd hidden column of each gate (the kernel's blocks are independent)
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("I", [1024, 512])
@pytest.mark.parametrize("B", [1, 8, 32])
def test_skinny_emulation_meets_the_cell_tolerance(B, I, dtype):
    """The small-batch form's sums (fmaf in k order in fp32, mma.sync's
    truncated accumulation in bf16, eight warps' partials in order) meet
    phase 3's fp32 limit, 1e-5 absolute and of scale, against the float64
    cell on the same inputs (bf16 inputs rounded first): in bf16 only the
    final rounding of h' to bf16 is left, which the card's 2e-2 holds."""
    H = 1024
    w, b, x, h, c = _draw_cell(B, I, H, 1)
    if dtype == BF16:
        w, x, h = _bf16(w), _bf16(x), _bf16(h)
    hidden = np.arange(0, H, 32)
    zc = np.concatenate([g * H + hidden for g in range(4)])
    a = np.concatenate([x, h], 1).astype(np.float64)
    h64, c64 = gates(a @ w[:, zc].astype(np.float64), b[zc], c[:, hidden], np.float64)
    hk, ck = emulate_skinny_cell(w, b, x, h, c, dtype, hidden)
    err = max(np.abs(hk - h64).max(), np.abs(ck - c64).max())
    scale = max(np.abs(h64).max(), np.abs(c64).max())
    assert err <= 1e-5 and err / scale <= 1e-5, err


# --- the form between the regimes (mcast), emulated ----------------------------
#
# The mcast kernel's arithmetic in numpy: [x|h] in k-tiles of 64 bf16 (x's
# tiles, then h's, zero-filled past I and H), each tile's four k16 slices in
# order, one wgmma m64n64k16 each into the block's one fp32 accumulator: an
# exact 16-term dot added to the running sum with the result rounded toward
# zero (the tensor cores' accumulation, as the skinny and tf32x3 emulations
# model it); then the bias and the gates in fp32.

MCAST_BK = 64


def emulate_mcast_z(x, h, w):
    """z = [x, h] @ W as the mcast kernel forms it: x [B, I], h [B, H], W
    [I + H, N] (columns of z) fp32 arrays holding bf16 values."""
    B, I = x.shape
    tiles = [(x[:, k:k + MCAST_BK], w[k:min(k + MCAST_BK, I)]) for k in range(0, I, MCAST_BK)]
    tiles += [(h[:, k:k + MCAST_BK], w[I + k:I + k + MCAST_BK]) for k in range(0, h.shape[1], MCAST_BK)]
    z = np.zeros((B, w.shape[1]), np.float32)
    for a, wt in tiles:
        a64, w64 = a.astype(np.float64), wt.astype(np.float64)
        for j in range(0, a.shape[1], 16):
            z = _toward_zero(z + a64[:, j:j + 16] @ w64[j:j + 16])
    return z


def emulate_mcast_cell(w, b, x, h, c, hidden=None):
    """The mcast kernel's (h' before its rounding to bf16, c') at the hidden
    columns ``hidden`` (all by default), fp32."""
    H = h.shape[1]
    hidden = np.arange(H) if hidden is None else hidden
    zc = np.concatenate([g * H + hidden for g in range(4)])
    return gates(emulate_mcast_z(x, h, w[:, zc]), b[zc], c[:, hidden], np.float32)


# the middle regime's batches (beam-3 at bucket 32, greedy at bucket 128 and
# the training batch, 3 x 64 for the eval driver's beam) at I=1024 and
# Show-and-Tell's I=512, every 64th hidden column of each gate
@pytest.mark.parametrize("I", [1024, 512])
@pytest.mark.parametrize("B", [96, 128, 192])
def test_mcast_emulation_meets_the_cell_tolerance(B, I):
    """The mcast form's sums (one accumulator over 16-deep products, each
    rounded toward zero) meet phase 3's fp32 limit, 1e-5 absolute and of
    scale, against the float64 cell on the same bf16-rounded inputs: only
    the final rounding of h' to bf16 is left, which the card's 2e-2 holds."""
    H = 1024
    w, b, x, h, c = _draw_cell(B, I, H, 2)
    w, x, h = _bf16(w), _bf16(x), _bf16(h)
    hidden = np.arange(0, H, 64)
    zc = np.concatenate([g * H + hidden for g in range(4)])
    a = np.concatenate([x, h], 1).astype(np.float64)
    h64, c64 = gates(a @ w[:, zc].astype(np.float64), b[zc], c[:, hidden], np.float64)
    hk, ck = emulate_mcast_cell(w, b, x, h, c, hidden)
    err = max(np.abs(hk - h64).max(), np.abs(ck - c64).max())
    scale = max(np.abs(h64).max(), np.abs(c64).max())
    assert err <= 1e-5 and err / scale <= 1e-5, err


def test_mcast_emulation_zero_fills_the_ragged_tile():
    """I not a multiple of the 64-deep k-tile: x's last tile is short, and
    the emulation's sums equal the same cell with x and W's rows padded by
    zeros to the tile (TMA's fill), bit for bit."""
    B, I, H = 7, 40, 16
    w, b, x, h, c = _draw_cell(B, I, H, 4)
    w, x, h = _bf16(w), _bf16(x), _bf16(h)
    xp = np.concatenate([x, np.zeros((B, MCAST_BK - I), np.float32)], 1)
    wp = np.concatenate([w[:I], np.zeros((MCAST_BK - I, 4 * H), np.float32), w[I:]], 0)
    np.testing.assert_array_equal(emulate_mcast_z(x, h, w), emulate_mcast_z(xp, h, wp))
