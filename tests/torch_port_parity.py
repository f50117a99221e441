"""Parity figures of the PyTorch port against the JAX package, on the CPU.

    python tests/torch_port_parity.py

Prints the max abs diff per output for the cases that the port's tests hold
to a tolerance (``tests/test_torch_port_*.py``), from the same inputs: the
port's plain versions against the JAX references and the JAX Pallas kernels
in interpret mode, the trunk, the decode step, decoded ids and captions,
the training forward, the autograd Functions' gradients and the train
step. Not a test module: it reports the numbers that the tests only bound.

It also holds ``to_jax_params``, the inverse of the port's
``ckpt.convert.from_jax_params``, which the training tests use to compare
the port's parameters and optimizer moments with the JAX package's trees.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_port_model as tm  # noqa: E402
import test_torch_port_ops as to  # noqa: E402
from show_and_tell_tpu.ops import attention as jattn  # noqa: E402
from show_and_tell_tpu.ops import fused_attention as jfa  # noqa: E402
from show_and_tell_tpu.ops import fused_decode_attention as jfda  # noqa: E402
from show_and_tell_tpu.ops import lstm as jlstm  # noqa: E402
from show_and_tell_tpu_torch.ops import fused_attention as tfa  # noqa: E402
from show_and_tell_tpu_torch.ops import fused_decode_attention as tfda  # noqa: E402
from show_and_tell_tpu_torch.ops import lstm as tlstm  # noqa: E402

DT = {"f32": to.F32, "bf16": to.BF16}


def to_jax_params(sd):
    """A port state dict (or any dict keyed by its parameter names, such as
    the Adam moments) -> the JAX package's ``(trainable, frozen)`` trees as
    numpy arrays; ``frozen`` is None without encoder weights."""
    a = {k: v.detach().cpu().float().numpy() for k, v in sd.items()}
    trainable = {"att": {k: a[f"att.{k}"] for k in ("w_img", "w_hh", "b_hh", "w_att")}, "embed": a["embed"]}
    for name in ("init_h", "init_c", "lstm", "c2o", "h2o", "classifier"):
        trainable[name] = {"w": a[f"{name}.w"], "b": a[f"{name}.b"]}
    n = len([k for k in a if k.startswith("encoder.convs.") and k.endswith(".w")])
    frozen = None
    if n:
        frozen = {"convs": [{"w": a[f"encoder.convs.{i}.w"].transpose(2, 3, 1, 0),
                             "b": a[f"encoder.convs.{i}.b"]} for i in range(n)]}
    return trainable, frozen


def _d(j, t) -> float:
    return float(np.abs(np.asarray(j, np.float32) - t.float().numpy()).max())


def row(what, **diffs):
    print(f"{what:58s} " + "  ".join(f"{k} {v:.2e}" for k, v in diffs.items()))


def cell():
    for dn, (jdt, tdt, _) in DT.items():
        for B, I, H in ((5, 40, 128), (3, 17, 24)):
            jin, tin = to._cell_inputs(B, I, H, jdt, tdt)
            jh, jc = jlstm.lstm_cell_reference(*jin)
            th, tc = tlstm.lstm_cell(*tin)
            row(f"lstm_cell B={B} I={I} H={H} {dn} vs reference", h=_d(jh, th), c=_d(jc, tc))
        jin, tin = to._cell_inputs(5, 40, 128, jdt, tdt, seed=1)
        jlstm.set_pallas_enabled(True, interpret=True)
        jh, jc = jlstm.lstm_cell(*jin)
        jlstm.set_pallas_enabled(None)
        th, tc = tlstm.lstm_cell(*tin)
        row(f"lstm_cell B=5 I=40 H=128 {dn} vs Pallas interpret", h=_d(jh, th), c=_d(jc, tc))


def attention():
    for L, D, dn in ((13, 32, "f32"), (16, 64, "f32"), (13, 64, "bf16"), (16, 32, "bf16")):
        jdt, tdt, _ = DT[dn]
        j, t = to._attn_inputs(6, 1, L, D, 24, jdt, tdt)
        ctx, alpha = tfa.fused_additive_attention(to._params(t), t["f"], t["ce"], t["hidden"])
        rc, ra = jattn.additive_attention(to._params(j), j["f"], j["ce"], j["hidden"])
        row(f"fused_additive_attention L={L} D={D} {dn} vs reference", ctx=_d(rc, ctx), alpha=_d(ra, alpha))
        jlstm.set_pallas_enabled(True, interpret=True)
        kc, ka = jfa.fused_additive_attention(to._params(j), j["f"], j["ce"], j["hidden"])
        jlstm.set_pallas_enabled(None)
        row(f"fused_additive_attention L={L} D={D} {dn} vs Pallas", ctx=_d(kc, ctx), alpha=_d(ka, alpha))
    for L, K, dn in ((13, 3, "f32"), (16, 1, "f32"), (13, 1, "bf16"), (16, 3, "bf16")):
        jdt, tdt, _ = DT[dn]
        B, D = 4, 32
        j, t = to._attn_inputs(B, K, L, D, 24, jdt, tdt, seed=2)
        hp_t = (t["hidden"] @ t["w_hh"] + t["b_hh"]).reshape(B, K, D)
        ctx, alpha = tfda.attention_beam(t["ce"], t["f"], hp_t, t["w_att"])
        rc, ra = jattn.additive_attention_beamed(to._params(j), j["f"], j["ce"], j["hidden"], K)
        row(f"attention_beam L={L} K={K} {dn} vs beamed reference",
            ctx=_d(rc, ctx.reshape(B * K, D)), alpha=_d(ra, alpha.reshape(B * K, L)))
        jlstm.set_pallas_enabled(True, interpret=True)
        hp_j = (j["hidden"] @ j["w_hh"] + j["b_hh"]).reshape(B, K, D)
        kc, ka = jfda.attention_beam(j["ce"], j["f"], hp_j, j["w_att"], variant="s32_cvpu")
        jlstm.set_pallas_enabled(None)
        row(f"attention_beam L={L} K={K} {dn} vs Pallas s32_cvpu", ctx=_d(kc, ctx), alpha=_d(ka, alpha))


def model():
    from show_and_tell_tpu.data import transforms as jtransforms
    from show_and_tell_tpu_torch.data import transforms

    imgs = np.random.default_rng(0).integers(0, 256, (2, 40, 44, 3), dtype=np.uint8)
    row("eval_transform crop 32", out=_d(jtransforms.eval_transform(jnp.asarray(imgs), 32),
                                        transforms.eval_transform(torch.from_numpy(imgs), 32)))
    _, jm, trainable, frozen, _, tmod = tm._pair()
    for crop in (32, 64):
        x = np.random.default_rng(crop).standard_normal((2, crop, crop, 3)).astype(np.float32)
        want = np.asarray(jm.backbone_features(frozen, jnp.asarray(x)))
        got = tmod.backbone_features(torch.from_numpy(x))
        row(f"vgg16 trunk crop {crop} (feature scale {np.abs(want).max():.3g})", features=_d(want, got))
    for dtype in ("float32", "bfloat16"):
        _, jm, trainable, _, _, tmod = tm._pair(dtype=dtype)
        for k in (1, 3):
            worst = max(float(np.abs(jl - tl).max()) for jl, tl in tm._forced_steps(jm, trainable, tmod, tm._feats(2), k))
            row(f"decode step logits, 5 forced steps, k={k} {dtype}", logits=worst)
    for mode in ("greedy", "beam"):
        for early in (True, False):
            want, got, _ = tm._decode_both(mode, early)
            row(f"{mode} ids B=3 max_len 8 early_stop={early} fp32", differing_ids=float((want != got).sum()))
    want, got, scores = tm._decode_both("beam", True, return_all=True)
    row("beam return_all n-best fp32", differing_ids=float((want != got).sum()),
        scores=float(np.abs(scores[0] - scores[1]).max()))


def variants():
    B, K, L, D = to.BEAM_SHAPE
    for dn, (jdt, tdt, _) in DT.items():
        (jce, jf, jhp, jw), (ce, f, hp, w) = to._beam_inputs(jdt, tdt)
        jlstm.set_pallas_enabled(True, interpret=True)
        for v in jfda.VARIANTS:
            ctx, alpha = tfda.attention_beam(ce, f, hp, w, variant=v)
            jv = v if dn == "f32" else "s32_cvpu"
            kc, ka = jfda.attention_beam(jce, jf, jhp, jw, variant=jv)
            row(f"attention_beam {v} B={B} K={K} L={L} D={D} {dn} vs Pallas {jv}",
                ctx=_d(kc, ctx), alpha=_d(ka, alpha))
        (jce, jf, jhp, jw), (ce, f, hp, w) = to._beam_inputs(jdt, tdt, seed=6)
        for v in jfda.SCORE_VARIANTS:
            jv = v if dn == "f32" else "s32"
            e = tfda.attention_scores(ce, hp, w, v)
            ctx, alpha = tfda.attention_beam_hybrid(ce, f, hp, w, v)
            kc, ka = jfda.attention_beam_hybrid(jce, jf, jhp, jw, variant=jv)
            row(f"attention_scores/hybrid {v} {dn} vs Pallas {jv}",
                e=_d(jfda.attention_scores(jce, jhp, jw, variant=jv), e), ctx=_d(kc, ctx), alpha=_d(ka, alpha))
        jlstm.set_pallas_enabled(None)


def functions():
    for B, I in ((5, 40), (3, 17)):
        want, got = to.cell_function_grads(B, I)
        row(f"LSTMCellFunction grads B={B} I={I} H=128 vs jax.grad _fused_cell",
            **{n: _d(jg, tg) for n, jg, tg in zip(("w", "b", "x", "h", "c"), want, got)})
    want, got = to.attention_function_grads()
    row("FusedAttentionFunction grads B=6 L=13 D=64 vs jax.grad _fused",
        **{n: _d(jg, tg) for n, jg, tg in zip(("ce", "f", "hp", "w_att"), want, got)})


def training():
    import test_torch_port_train as tt

    _, jm, trainable, _, _, tmod = tm._pair()
    jb, tb = tt._batch()
    want = jm.decode_train(trainable, jb["features"], jb["captions"], jb["lengths"])
    got = tmod.decode_train(tb["features"], tb["captions"], tb["lengths"])
    row("decode_train fast path fp32", logits=_d(want[0], got[0].detach()), alphas=_d(want[2], got[2].detach()))
    jb, tb = tt._batch(seed=1)
    for ss in (0.0, 1.0):
        want = jm.decode_train(trainable, jb["features"], jb["captions"], jb["lengths"],
                               ss_prob=jnp.asarray(ss, jnp.float32))
        got = tmod.decode_train(tb["features"], tb["captions"], tb["lengths"], ss_prob=torch.tensor(ss))
        row(f"decode_train general path ss_prob={ss} fp32",
            logits=_d(want[0], got[0].detach()), alphas=_d(want[2], got[2].detach()))
    for case in tt.CASES:
        jstate, state, metrics = tt.train_both(case)
        diffs = jax.tree.leaves(jax.tree.map(
            lambda w, g: float(np.abs(np.asarray(w) - g).max()),
            jstate.params, to_jax_params(state.params)[0]))
        adam = tt._adam_state(jstate.opt_state)
        mu = jax.tree.leaves(jax.tree.map(lambda w, g: float(np.abs(np.asarray(w) - g).max()),
                                          adam.mu, to_jax_params(state.opt_state["mu"])[0]))
        nu = jax.tree.leaves(jax.tree.map(lambda w, g: float(np.abs(np.asarray(w) - g).max()),
                                          adam.nu, to_jax_params(state.opt_state["nu"])[0]))
        loss = max(abs(float(jm_["loss"]) - float(m["loss"])) for jm_, m in metrics if np.isfinite(float(m["loss"])))
        row(f"3 train steps lr {tt.LR} [{case}]", params=max(diffs), mu=max(mu), nu=max(nu), loss=loss)
    imgs = np.random.default_rng(7).integers(0, 256, (2, 40, 36, 3), dtype=np.uint8)
    from show_and_tell_tpu.data import transforms as jtransforms
    from show_and_tell_tpu_torch.data import transforms

    for size in (16, 64):
        row(f"resize_bilinear 40x36 -> {size} (values 0..255)",
            out=_d(jtransforms.resize_bilinear(jnp.asarray(imgs), size),
                   transforms.resize_bilinear(torch.from_numpy(imgs), size)))


def main():
    print(f"jax {jax.__version__}, torch {torch.__version__}, CPU")
    cell()
    attention()
    variants()
    functions()
    model()
    training()


if __name__ == "__main__":
    main()
