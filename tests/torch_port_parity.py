"""Parity figures of the PyTorch port against the JAX package, on the CPU.

    python tests/torch_port_parity.py

Prints the max abs diff per output for the cases that the port's tests hold
to a tolerance (``tests/test_torch_port_*.py``), from the same inputs: the
port's plain versions against the JAX references and the JAX Pallas kernels
in interpret mode, the trunk, the decode step, decoded ids and captions.
Not a test module: it reports the numbers that the tests only bound.
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


def main():
    print(f"jax {jax.__version__}, torch {torch.__version__}, CPU")
    cell()
    attention()
    model()


if __name__ == "__main__":
    main()
