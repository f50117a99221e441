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
    """The header of each source names, as `path` `function`, the JAX
    package's Pallas kernels it replaces, and they exist there."""
    header = []
    for line in _source(src).splitlines():
        if not line.startswith("//"):
            break
        header.append(line[2:])
    text = " ".join(header)
    files = re.findall(r"(show_and_tell_tpu/[\w/]+\.py)", text)
    fns = re.findall(r"`(_\w+)`", text)
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
