"""PyTorch port, kernels' modules: the plain versions against the JAX package.

Inputs come from numpy and go to both packages. The JAX Pallas kernels run
in interpret mode on the CPU, as the JAX package's own tests run them. On
CPU tensors the port's wrappers take their plain versions; the CUDA kernels
themselves are checked on the card by chip_smoke.py.
"""

import ast
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from show_and_tell_tpu.ops import attention as jattn
from show_and_tell_tpu.ops import fused_attention as jfa
from show_and_tell_tpu.ops import fused_decode_attention as jfda
from show_and_tell_tpu.ops import lstm as jlstm
from show_and_tell_tpu_torch.ops import cuda_lib
from show_and_tell_tpu_torch.ops import fused_attention as tfa
from show_and_tell_tpu_torch.ops import fused_decode_attention as tfda
from show_and_tell_tpu_torch.ops import lstm as tlstm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "show_and_tell_tpu_torch")
KERNELS = ("lstm_cell", "additive_attention", "attention_beam")

# (jax dtype, torch dtype, atol)
F32 = (jnp.float32, torch.float32, None)
BF16 = (jnp.bfloat16, torch.bfloat16, 2e-2)


@pytest.fixture(autouse=True)
def _reset_pallas():
    yield
    jlstm.set_pallas_enabled(None)


def _both(a, jdt, tdt):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _close(j, t, atol):
    np.testing.assert_allclose(
        np.asarray(j, np.float32), t.float().numpy(), atol=atol, rtol=0
    )


def _cell_inputs(B, I, H, jdt, tdt, seed=0):
    rng = np.random.default_rng(seed)
    k = 1 / np.sqrt(H)
    w = rng.uniform(-k, k, (I + H, 4 * H))
    b = rng.uniform(-k, k, (4 * H,))
    x, h, c = (rng.standard_normal(s) for s in ((B, I), (B, H), (B, H)))
    jw, tw = _both(w, jdt, tdt)
    jx, tx = _both(x, jdt, tdt)
    jh, th = _both(h, jdt, tdt)
    jb, tb = _both(b, jnp.float32, torch.float32)
    jc, tc = _both(c, jnp.float32, torch.float32)
    return ({"w": jw, "b": jb}, jx, jh, jc), ({"w": tw, "b": tb}, tx, th, tc)


@pytest.mark.parametrize("B,I,H", [(5, 40, 128), (3, 17, 24)])
@pytest.mark.parametrize("dt", [F32, BF16], ids=["f32", "bf16"])
def test_cell_plain_matches_jax_reference(B, I, H, dt):
    jdt, tdt, atol = dt
    jin, tin = _cell_inputs(B, I, H, jdt, tdt)
    jh, jc = jlstm.lstm_cell_reference(*jin)
    th, tc = tlstm.lstm_cell(*tin)
    assert th.dtype == tdt and tc.dtype == torch.float32
    _close(jh, th, atol or 1e-5)
    _close(jc, tc, atol or 1e-5)


@pytest.mark.parametrize("dt", [F32, BF16], ids=["f32", "bf16"])
def test_cell_plain_matches_jax_pallas_interpret(dt):
    jdt, tdt, atol = dt
    jin, tin = _cell_inputs(5, 40, 128, jdt, tdt, seed=1)
    jlstm.set_pallas_enabled(True, interpret=True)
    jh, jc = jlstm.lstm_cell(*jin)
    th, tc = tlstm.lstm_cell(*tin)
    _close(jh, th, atol or 1e-5)
    _close(jc, tc, atol or 1e-5)


def _attn_inputs(B, K, L, D, H, jdt, tdt, seed=0):
    rng = np.random.default_rng(seed)
    names = ("ce", "f", "hidden", "w_hh", "b_hh", "w_att")
    shapes = ((B, L, D), (B, L, D), (B * K, H), (H, D), (D,), (D,))
    out = {n: _both(rng.standard_normal(s) * (0.2 if n == "w_hh" else 1.0), jdt, tdt)
           for n, s in zip(names, shapes)}
    j = {n: v[0] for n, v in out.items()}
    t = {n: v[1] for n, v in out.items()}
    return j, t


def _params(d):
    return {k: d[k] for k in ("w_hh", "b_hh", "w_att")}


@pytest.mark.parametrize(
    "L,D,dt", [(13, 32, F32), (16, 64, F32), (13, 64, BF16), (16, 32, BF16)],
    ids=["L13-D32-f32", "L16-D64-f32", "L13-D64-bf16", "L16-D32-bf16"],
)
def test_fused_additive_attention_matches_jax(L, D, dt):
    jdt, tdt, atol = dt
    atol = atol or 2e-5
    j, t = _attn_inputs(6, 1, L, D, 24, jdt, tdt)
    ctx, alpha = tfa.fused_additive_attention(_params(t), t["f"], t["ce"], t["hidden"])
    assert ctx.shape == (6, D) and ctx.dtype == tdt and alpha.dtype == torch.float32
    # the JAX package's plain attention
    rctx, ralpha = jattn.additive_attention(_params(j), j["f"], j["ce"], j["hidden"])
    _close(rctx, ctx, atol)
    _close(ralpha, alpha, atol)
    # the JAX Pallas kernel, interpreted
    jlstm.set_pallas_enabled(True, interpret=True)
    kctx, kalpha = jfa.fused_additive_attention(_params(j), j["f"], j["ce"], j["hidden"])
    _close(kctx, ctx, atol)
    _close(kalpha, alpha, atol)


@pytest.mark.parametrize(
    "L,K,dt", [(13, 3, F32), (16, 1, F32), (13, 1, BF16), (16, 3, BF16)],
    ids=["L13-K3-f32", "L16-K1-f32", "L13-K1-bf16", "L16-K3-bf16"],
)
def test_attention_beam_matches_jax(L, K, dt):
    jdt, tdt, atol = dt
    atol = atol or 2e-5
    B, D = 4, 32
    j, t = _attn_inputs(B, K, L, D, 24, jdt, tdt, seed=2)
    hp_t = (t["hidden"] @ t["w_hh"] + t["b_hh"]).reshape(B, K, D)
    ctx, alpha = tfda.attention_beam(t["ce"], t["f"], hp_t, t["w_att"])
    assert ctx.shape == (B, K, D) and alpha.shape == (B, K, L)
    # the JAX model's beamed attention (rows beam-major per image)
    rctx, ralpha = jattn.additive_attention_beamed(
        _params(j), j["f"], j["ce"], j["hidden"], K
    )
    _close(rctx, ctx.reshape(B * K, D), atol)
    _close(ralpha, alpha.reshape(B * K, L), atol)
    # the JAX Pallas kernel, interpreted, on the same projections
    jlstm.set_pallas_enabled(True, interpret=True)
    hp_j = (j["hidden"] @ j["w_hh"] + j["b_hh"]).reshape(B, K, D)
    kctx, kalpha = jfda.attention_beam(j["ce"], j["f"], hp_j, j["w_att"], variant="s32_cvpu")
    _close(kctx, ctx, atol)
    _close(kalpha, alpha, atol)


def test_wrappers_take_plain_path_on_cpu():
    cuda_lib.LAUNCHES.clear()
    _, (p, x, h, c) = _cell_inputs(3, 8, 16, None, torch.float32)
    hw, cw = tlstm.lstm_cell(p, x, h, c)
    hr, cr = tlstm.lstm_cell_reference(p, x, h, c)
    assert torch.equal(hw, hr) and torch.equal(cw, cr)
    _, t = _attn_inputs(2, 3, 5, 8, 16, None, torch.float32)
    hp = t["hidden"] @ t["w_hh"] + t["b_hh"]
    got = tfda.attention_beam(t["ce"], t["f"], hp.reshape(2, 3, 8), t["w_att"])
    want = tfda.attention_beam_reference(t["ce"], t["f"], hp.reshape(2, 3, 8), t["w_att"])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = tfa.fused_attention(t["ce"], t["f"], hp[:2], t["w_att"])
    want = tfa.attention_reference(t["ce"], t["f"], hp[:2], t["w_att"])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(cuda_lib.LAUNCHES[k] == 0 for k in KERNELS)


def test_kernel_launchers_refuse_cpu_tensors():
    """The kernel entry points never run, or fall back, on CPU tensors."""
    _, (p, x, h, c) = _cell_inputs(3, 8, 16, None, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tlstm.lstm_cell_cuda(p, x, h, c)
    _, t = _attn_inputs(2, 3, 5, 8, 16, None, torch.float32)
    hp = torch.zeros(2, 3, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.launch_attention("attention_beam", t["ce"], t["f"], hp, t["w_att"])
    assert all(cuda_lib.LAUNCHES[k] == 0 for k in KERNELS)


def test_cuda_sources_export_the_bound_symbols():
    """Every C function the ctypes bindings declare is defined extern "C"
    in its source, with as many parameters as the binding passes."""
    for src, fns in cuda_lib._SIGNATURES.items():
        with open(os.path.join(cuda_lib.CSRC, src)) as fh:
            code = fh.read()
        assert "arch=compute_90a" in " ".join(cuda_lib.NVCC_FLAGS)
        for name, argtypes in fns.items():
            m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", code)
            assert m, f"{src} does not define {name}"
            params = [a for a in m.group(1).split(",") if a.strip()]
            assert len(params) == len(argtypes), (name, params)


_FORBIDDEN = re.compile(r"^(jax|jaxlib|flax|optax|show_and_tell_tpu)(\.|$)")


def test_port_imports_nothing_of_jax():
    """Neither the port's package nor chip_smoke.py, which drives it on the
    card, imports JAX or the JAX package."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        paths += [os.path.join(root, fn) for fn in files if fn.endswith(".py")]
    bad = []
    for path in paths:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path}: {n}" for n in names if _FORBIDDEN.match(n)]
    assert not bad, bad
    assert _FORBIDDEN.match("show_and_tell_tpu.ops")
    assert not _FORBIDDEN.match("show_and_tell_tpu_torch.ops")
