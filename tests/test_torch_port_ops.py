"""PyTorch port, kernels' modules: the plain versions against the JAX package.

Inputs come from numpy and go to both packages. The JAX Pallas kernels run
in interpret mode on the CPU, as the JAX package's own tests run them. On
CPU tensors the port's wrappers take their plain versions; the CUDA kernels
themselves are checked on the card by chip_smoke.py.
"""

import ast
import gc
import os
import re

import jax
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
from show_and_tell_tpu_torch.ops import tanh_probe as tprobe
from test_torch_port_kernel_sources import _bf16, emulate_mcast_cell, emulate_skinny_cell, emulate_tf32x3_cell

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "show_and_tell_tpu_torch")
KERNELS = (
    "lstm_cell", "additive_attention", "attention_beam",
    "attention_beam_grid2", "attention_beam_st", "attention_scores", "tanh_probe",
)

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
    hp3 = hp.reshape(2, 3, 8)
    for variant in tfda.VARIANTS:
        got = tfda.attention_beam(t["ce"], t["f"], hp3, t["w_att"], variant=variant)
        want = tfda.attention_beam_reference(t["ce"], t["f"], hp3, t["w_att"])
        assert all(torch.equal(a, b) for a, b in zip(got, want)), variant
    got = tfda.attention_beam_st(t["ce"].transpose(1, 2).contiguous(), t["f"], hp3, t["w_att"])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for variant in tfda.SCORE_VARIANTS:
        assert torch.equal(tfda.attention_scores(t["ce"], hp3, t["w_att"], variant),
                           tfda.attention_scores_reference(t["ce"], hp3, t["w_att"]))
    for form in (None, *tprobe.TANH_FORMS):
        assert torch.equal(tprobe.tanh_probe(t["ce"], hp3, form), tprobe.tanh_probe_reference(t["ce"], hp3))
    assert all(cuda_lib.LAUNCHES[k] == 0 for k in KERNELS)


def test_kernel_launchers_refuse_cpu_tensors():
    """The kernel entry points never run, or fall back, on CPU tensors."""
    _, (p, x, h, c) = _cell_inputs(3, 8, 16, None, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tlstm.lstm_cell_cuda(p, x, h, c)
    _, t = _attn_inputs(2, 3, 5, 8, 16, None, torch.float32)
    hp = torch.zeros(2, 3, 8)
    for name in ("additive_attention", "attention_beam_grid2"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            tfa.launch_attention(name, t["ce"], t["f"], hp, t["w_att"])
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfda.attention_beam_cluster(t["ce"], t["f"], hp, t["w_att"])
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.attention_rows(t["ce"], t["f"], hp[:, 0], t["w_att"])
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfda.attention_scores_direct(t["ce"], hp, t["w_att"])
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfda.attention_beam_grid2(t["ce"], t["f"], hp, t["w_att"])
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfda.attention_beam_st_direct(t["ce"].transpose(1, 2).contiguous(), t["f"], hp, t["w_att"])
    assert all(cuda_lib.LAUNCHES[k] == 0 for k in KERNELS)


# --- the variant names of the beam attention (rows 3-6 of the kernel table) --

BEAM_SHAPE = (8, 3, 13, 64)  # B, K, L, D: the JAX package's own test shape


def _beam_inputs(jdt, tdt, seed=5):
    B, K, L, D = BEAM_SHAPE
    rng = np.random.default_rng(seed)
    s = np.sqrt(6.0 / (D + 1))  # the model's w_att init scale
    arrays = (rng.standard_normal((B, L, D)), rng.standard_normal((B, L, D)),
              rng.standard_normal((B, K, D)), rng.uniform(-s, s, (D,)))
    pairs = [_both(a, jdt, tdt) for a in arrays]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def test_variant_names_match_jax():
    assert tfda.VARIANTS == jfda.VARIANTS
    assert tfda.SCORE_VARIANTS == jfda.SCORE_VARIANTS


@pytest.mark.parametrize("dt", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", jfda.VARIANTS)
def test_attention_beam_variant_matches_jax_pallas(variant, dt):
    """Every name of VARIANTS against the JAX Pallas kernel of the same name
    in interpret mode (fp32), or its s32 form (bf16: the TPU's s16 and st
    forms round products to bf16, which the port does not reproduce)."""
    jdt, tdt, atol = dt
    (jce, jf, jhp, jw), (ce, f, hp, w) = _beam_inputs(jdt, tdt)
    ctx, alpha = tfda.attention_beam(ce, f, hp, w, variant=variant)
    assert ctx.shape == BEAM_SHAPE[:2] + BEAM_SHAPE[3:] and ctx.dtype == tdt
    assert alpha.shape == BEAM_SHAPE[:3] and alpha.dtype == torch.float32
    jlstm.set_pallas_enabled(True, interpret=True)
    kctx, kalpha = jfda.attention_beam(
        jce, jf, jhp, jw, variant=variant if tdt == torch.float32 else "s32_cvpu"
    )
    _close(kctx, ctx, atol or 2e-5)
    _close(kalpha, alpha, atol or 2e-5)


@pytest.mark.parametrize("dt", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", jfda.SCORE_VARIANTS)
def test_attention_scores_and_hybrid_match_jax_pallas(variant, dt):
    """attention_scores and attention_beam_hybrid for every name of
    SCORE_VARIANTS against the JAX Pallas score kernel in interpret mode (in
    bf16 against its s32 form)."""
    jdt, tdt, atol = dt
    atol = atol or 2e-5
    (jce, jf, jhp, jw), (ce, f, hp, w) = _beam_inputs(jdt, tdt, seed=6)
    e = tfda.attention_scores(ce, hp, w, variant)
    ctx, alpha = tfda.attention_beam_hybrid(ce, f, hp, w, variant)
    assert e.shape == BEAM_SHAPE[:3] and e.dtype == torch.float32
    jlstm.set_pallas_enabled(True, interpret=True)
    jv = variant if tdt == torch.float32 else "s32"
    _close(jfda.attention_scores(jce, jhp, jw, variant=jv), e, atol)
    kctx, kalpha = jfda.attention_beam_hybrid(jce, jf, jhp, jw, variant=jv)
    _close(kctx, ctx, atol)
    _close(kalpha, alpha, atol)


@pytest.mark.parametrize("dt", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,K,L,D", [(4, 3, 13, 64), (2, 1, 5, 36)])
def test_tanh_probe_plain_matches_jax(B, K, L, D, dt):
    """tanh_probe's plain version against the JAX benchmark's expression for
    the same sum (``xstep`` of ``micro_tanh``: tanh(ce + hp) in the input
    type, summed over k and l, as fp32) in jax.numpy, fp32 within 1e-5 and
    bf16 within 2e-2 of the output's scale. The Pallas body itself is nested
    in ``micro_tanh`` with its shapes and no interpret switch, so it cannot be
    called from a test; its body is that expression, beam by beam."""
    jdt, tdt, _ = dt
    rng = np.random.default_rng(7)
    jce, ce = _both(rng.standard_normal((B, L, D)), jdt, tdt)
    jhp, hp = _both(rng.standard_normal((B, K, D)), jdt, tdt)
    out = tprobe.tanh_probe(ce, hp)
    assert out.shape == (B, D) and out.dtype == torch.float32
    t = jnp.tanh(jce[:, None, :, :] + jhp[:, :, None, :])
    want = np.asarray(jnp.sum(t, axis=(1, 2)).astype(jnp.float32))
    # the kernel body's order: per beam a sum over l in the input type, the
    # beams added in fp32
    body = sum(np.asarray(jnp.sum(jnp.tanh(jce + jhp[:, k, :][:, None, :]), axis=1).astype(jnp.float32))
               for k in range(K))
    for ref in (want, body):
        atol = 1e-5 if tdt == torch.float32 else 2e-2 * np.abs(ref).max()
        np.testing.assert_allclose(out.numpy(), ref, atol=atol, rtol=0)


def test_tanh_probe_refuses_unknown_forms():
    ce, hp = torch.zeros(2, 3, 8), torch.zeros(2, 1, 8)
    with pytest.raises(ValueError, match="unknown tanh form"):
        tprobe.tanh_probe(ce, hp, "tanh16")
    assert set(tprobe.DEFAULT_FORM.values()) <= set(tprobe.TANH_FORMS)


def test_unknown_variant_raises():
    _, (ce, f, hp, w) = _beam_inputs(None, torch.float32)
    with pytest.raises(ValueError, match="unknown variant"):
        tfda.attention_beam(ce, f, hp, w, variant="s64_cvpu")
    with pytest.raises(ValueError, match="unknown variant"):
        tfda.attention_scores(ce, hp, w, variant="st")
    with pytest.raises(ValueError, match="unknown variant"):
        tfda.attention_beam_hybrid(ce, f, hp, w, variant="grid2")


# --- the autograd Functions that training runs -------------------------------


def _torch_leaves(*arrays):
    return [torch.from_numpy(np.array(a, np.float32)).requires_grad_() for a in arrays]


def cell_function_grads(B, I, H=128):
    """(jax.grad through _fused_cell, LSTMCellFunction's grads) of one
    weighted sum of (h', c'), inputs (w, b, x, h, c)."""
    (jp, jx, jh, jc), _ = _cell_inputs(B, I, H, jnp.float32, torch.float32, seed=3)
    rng = np.random.default_rng(4)
    rh, rc = rng.standard_normal((B, H)), rng.standard_normal((B, H))
    jlstm.set_pallas_enabled(True, interpret=True)

    def jloss(w, b, x, h, c):
        hn, cn = jlstm._fused_cell(w, b, x, h, c)
        return jnp.sum(hn * rh) + jnp.sum(cn * rc)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(jp["w"], jp["b"], jx, jh, jc)
    jlstm.set_pallas_enabled(None)
    leaves = _torch_leaves(jp["w"], jp["b"], jx, jh, jc)
    w, b, x, h, c = leaves
    hn, cn = tlstm.lstm_cell({"w": w, "b": b}, x, h, c)
    assert type(hn.grad_fn).__name__.startswith("LSTMCellFunction")
    ((hn * torch.from_numpy(rh).float()).sum() + (cn * torch.from_numpy(rc).float()).sum()).backward()
    return want, [t.grad for t in leaves]


@pytest.mark.parametrize("B,I", [(5, 40), (3, 17)])
def test_cell_function_grads_match_jax(B, I):
    """LSTMCellFunction's input gradients against jax.grad through
    _fused_cell (the Pallas forward in interpret mode, the XLA recompute
    backward)."""
    for jg, tg in zip(*cell_function_grads(B, I)):
        _close(jg, tg, 1e-5)


def attention_function_grads():
    """(jax.grad through _fused, FusedAttentionFunction's grads through
    fused_attention) of one weighted sum of (ctx, alpha), inputs
    (ce, f, hp, w_att)."""
    B, L, D, H = 6, 13, 64, 24
    j, _ = _attn_inputs(B, 1, L, D, H, jnp.float32, torch.float32, seed=7)
    rng = np.random.default_rng(8)
    rctx, ralpha = rng.standard_normal((B, D)), rng.standard_normal((B, L))
    jlstm.set_pallas_enabled(True, interpret=True)

    def jloss(ce, f, hp, watt):
        ctx, alpha = jfa._fused(ce, f, hp, watt)
        return jnp.sum(ctx * rctx) + jnp.sum(alpha * ralpha)

    jhp = j["hidden"] @ j["w_hh"] + j["b_hh"]
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(j["ce"], j["f"], jhp, j["w_att"])
    jlstm.set_pallas_enabled(None)
    leaves = _torch_leaves(j["ce"], j["f"], jhp, j["w_att"])
    ctx, alpha = tfa.fused_attention(*leaves)
    assert type(ctx.grad_fn).__name__.startswith("FusedAttentionFunction")
    loss = (ctx * torch.from_numpy(rctx).float()).sum() + (alpha * torch.from_numpy(ralpha).float()).sum()
    loss.backward()
    return want, [t.grad for t in leaves]


def test_attention_function_grads_match_jax():
    """FusedAttentionFunction's input gradients, through fused_attention,
    against jax.grad through _fused (the Pallas forward in interpret mode,
    the XLA recompute backward)."""
    for jg, tg in zip(*attention_function_grads()):
        _close(jg, tg, 1e-5)


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
    assert os.path.join(PORT, "models", "quantize.py") in paths  # the int8 trunk
    assert os.path.join(PORT, "parallel", "distributed.py") in paths  # multi-device
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


# What of the JAX package has no counterpart of the same name in the port,
# and why (ROADMAP.md A10): a module by its path, a public function or class
# by "path:name".
NOT_PORTED = {
    "utils/compile_cache.py": "JAX's persistent XLA compile cache: the port compiles no XLA, and its kernel and "
                              "scorer builds are cached in show_and_tell_tpu_torch/_build/",
    "ops/lstm.py:set_pallas_enabled": "the Pallas toggle (Config.use_pallas): the port's wrappers pick the kernel "
                                      "by the tensor's device",
    "ops/lstm.py:pallas_active": "the Pallas toggle's reader, as set_pallas_enabled",
    "parallel/mesh.py:batch_sharding": "a NamedSharding: the port keeps each rank's rows (shard_batch)",
    "parallel/mesh.py:replicated": "a NamedSharding: the port broadcasts from rank 0 (replicate)",
    "train/step.py:make_optimizer": "the optax chain: the port writes the clamp and Adam out (_adam_update)",
    "models/layers.py:kaiming_conv": "inside the port's init_conv",
    "models/show_attend_tell.py:ShowAttendTellModel": "the port's nn.Module is ShowAttendTell",
    "models/show_tell.py:ShowTellModel": "the port's nn.Module is ShowTell",
}


def _public_names(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and not n.name.startswith("_")}


def test_every_jax_module_and_public_name_has_a_port_counterpart():
    """The closing inventory: every module of the JAX package has a module
    of the same path in the port, and every public top-level function and
    class of it one of the same name there, or it is in NOT_PORTED with
    its reason; and NOT_PORTED names nothing that the port has since
    gained."""
    jax_pkg = os.path.join(REPO, "show_and_tell_tpu")
    missing, stale = [], [k for k in NOT_PORTED]
    for root, _, files in os.walk(jax_pkg):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, fn), jax_pkg).replace(os.sep, "/")
            port = os.path.join(PORT, rel)
            if not os.path.exists(port):
                (stale.remove if rel in NOT_PORTED else missing.append)(rel)
                continue
            for name in sorted(_public_names(os.path.join(root, fn)) - _public_names(port)):
                key = f"{rel}:{name}"
                (stale.remove if key in NOT_PORTED else missing.append)(key)
    assert not missing, f"no counterpart in the port and no reason in NOT_PORTED: {missing}"
    assert not stale, f"NOT_PORTED entries that the port has, or that the JAX package no longer has: {stale}"


# --- the fp32 cell's 3xTF32 design ---------------------------------------------


@pytest.mark.parametrize("B,I,H", [(5, 40, 128), (9, 48, 40)])
def test_tf32x3_emulation_matches_jax_pallas_interpret(B, I, H):
    """The tf32x3 kernel's arithmetic (numpy emulation, W split by the
    port's ``tf32x3_weight``) against the JAX cell's Pallas kernel in
    interpret mode, fp32, within phase 3's 1e-5."""
    jin, _ = _cell_inputs(B, I, H, jnp.float32, torch.float32, seed=2)
    jlstm.set_pallas_enabled(True, interpret=True)
    jh, jc = jlstm.lstm_cell(*jin)
    jp, jx, jhid, jcell = jin
    eh, ec = emulate_tf32x3_cell(*(np.asarray(a, np.float32) for a in (jp["w"], jp["b"], jx, jhid, jcell)))
    np.testing.assert_allclose(eh, np.asarray(jh), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ec, np.asarray(jc), atol=1e-5, rtol=0)


def test_tf32x3_weight_copy_follows_the_weight():
    """The prepared W of the tf32x3 design is made once per weight version:
    the same copy while W is unchanged, a new one after an in-place update
    (an optimizer step) and after ``load_state_dict``, each equal to a fresh
    split; it is in no ``state_dict`` and dies with its weight."""
    from show_and_tell_tpu_torch import ckpt
    from show_and_tell_tpu_torch.config import Config
    from show_and_tell_tpu_torch.models.registry import build_model

    cfg = Config(embed_size=16, hidden_size=24, crop_size=32)
    model = build_model(cfg, 40, device="cpu", generator=torch.Generator().manual_seed(0))
    w = model.trainable_tree()["lstm"]["w"]
    keys = set(model.state_dict())
    key0, p0 = tlstm.weight_key(w), tlstm.prepared_weight(w)
    assert tlstm.prepared_weight(w) is p0 and torch.equal(p0, tlstm.tf32x3_weight(w))
    with torch.no_grad():
        w.add_(0.25)
    key1 = tlstm.weight_key(w)
    assert key1 != key0
    p1 = tlstm.prepared_weight(w)
    assert p1 is not p0 and torch.equal(p1, tlstm.tf32x3_weight(w))
    other = build_model(cfg, 40, device="cpu", generator=torch.Generator().manual_seed(1))
    model.load_state_dict(other.state_dict())
    assert tlstm.weight_key(w) != key1
    p2 = tlstm.prepared_weight(w)
    assert torch.equal(p2, tlstm.tf32x3_weight(other.trainable_tree()["lstm"]["w"]))
    for sd in (model.state_dict(), ckpt.trainable_state_dict(model)):
        assert all(t.data_ptr() != p2.data_ptr() and t.shape != p2.shape for t in sd.values())
    assert set(model.state_dict()) == keys
    n = len(tlstm._PREPARED)
    del model, w, sd
    gc.collect()
    assert len(tlstm._PREPARED) == n - 1
    with torch.inference_mode():  # no version counter: split afresh, never kept
        wi = torch.ones(8, 12)
        assert torch.equal(tlstm.prepared_weight(wi), tlstm.tf32x3_weight(wi))
    assert len(tlstm._PREPARED) == n - 1


# --- the small-batch cell (skinny) -----------------------------------------------


@pytest.mark.parametrize("dt", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,I", [(1, 1024), (8, 512), (32, 1024), (5, 40)])
def test_skinny_emulation_matches_jax_pallas_interpret(B, I, dt):
    """The small-batch form's arithmetic (numpy emulation) against the JAX
    cell's Pallas kernel in interpret mode on the same inputs: c' (fp32)
    within 1e-5, and h' within 1e-5 in fp32; in bf16 the JAX kernel hands h'
    back rounded to bf16, so the emulation's h' rounded the same way sits at
    most one bf16 step (2^-8 of |h'| <= 1) from it, where the two fp32
    values straddle a rounding boundary."""
    jdt, tdt, _ = dt
    jin, _ = _cell_inputs(B, I, 128, jdt, tdt, seed=3)
    jlstm.set_pallas_enabled(True, interpret=True)
    jh, jc = jlstm.lstm_cell(*jin)
    jp, jx, jhid, jcell = jin
    eh, ec = emulate_skinny_cell(*(np.asarray(a, np.float32) for a in (jp["w"], jp["b"], jx, jhid, jcell)), tdt)
    np.testing.assert_allclose(ec, np.asarray(jc), atol=1e-5, rtol=0)
    if tdt == torch.float32:
        np.testing.assert_allclose(eh, np.asarray(jh), atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(_bf16(eh), np.asarray(jh, np.float32), atol=2.0 ** -8, rtol=0)


@pytest.mark.parametrize("design", ["skinny", "mcast", "wgmma", "tf32x3"])
def test_cell_by_name_refuses_cpu_tensors(design):
    """The timing entry that launches a design by name is a kernel launcher:
    no plain path on CPU tensors, whichever design it names."""
    _, (p, x, h, c) = _cell_inputs(3, 8, 16, None, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tlstm.lstm_cell_by(design, p, x, h, c)


@pytest.mark.parametrize("tdt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_mcast_stream_refuses_cpu_tensors(tdt):
    """The cluster form's loads alone, for timing, launch a kernel or raise:
    no plain path on CPU tensors, in either type."""
    _, (p, x, h, c) = _cell_inputs(96, 8, 16, None, tdt)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tlstm.mcast_stream(p, x, h, c)


def test_mcast_clusters_needs_the_card():
    """The query of how many mcast clusters run at once asks the CUDA
    runtime; without a card it raises rather than guess."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py phase 4 prints the query")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        tlstm.mcast_clusters()


# --- the cell between the regimes (mcast) ----------------------------------------


@pytest.mark.parametrize("B,I", [(80, 40), (80, 512), (96, 40), (96, 512)])
def test_mcast_emulation_matches_jax_pallas_interpret(B, I):
    """The cluster form's arithmetic (numpy emulation: 64-deep k-tiles of x,
    then of h, each in four 16-deep products into one fp32 accumulator)
    against the JAX cell's Pallas kernel in interpret mode on the same bf16
    inputs, H=128: c' (fp32) within 1e-5; h', which the JAX kernel hands
    back rounded to bf16, within one bf16 step (2^-8 of |h'| <= 1) of the
    emulation's rounded the same way, where the two fp32 values straddle a
    rounding boundary."""
    jin, _ = _cell_inputs(B, I, 128, jnp.bfloat16, torch.bfloat16, seed=5)
    jlstm.set_pallas_enabled(True, interpret=True)
    jh, jc = jlstm.lstm_cell(*jin)
    jp, jx, jhid, jcell = jin
    eh, ec = emulate_mcast_cell(*(np.asarray(a, np.float32) for a in (jp["w"], jp["b"], jx, jhid, jcell)))
    np.testing.assert_allclose(ec, np.asarray(jc), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_bf16(eh), np.asarray(jh, np.float32), atol=2.0 ** -8, rtol=0)


def test_tiled_by_name_refuses_cpu_tensors():
    """The timing entry that launches the tiled kernel by name is a kernel
    launcher: no plain path on CPU tensors."""
    _, (p, x, h, c) = _cell_inputs(3, 8, 16, None, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tlstm.lstm_cell_by("tiled", p, x, h, c)
