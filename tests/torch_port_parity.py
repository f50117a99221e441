"""Parity figures of the PyTorch port against the JAX package, on the CPU.

    python tests/torch_port_parity.py

Prints the max abs diff per output for the cases that the port's tests hold
to a tolerance (``tests/test_torch_port_*.py``), from the same inputs: the
port's plain versions against the JAX references and the JAX Pallas kernels
in interpret mode, the trunk, the decode step, decoded ids and captions,
the training forward, the autograd Functions' gradients, the train step,
the n-best scores and attention maps of the Captioner, the sampler's
distance from its filtered softmax, a JAX train state resumed in the
port, and the trainer's losses and final params against the JAX trainer's
from one checkpoint, and the HTTP server's n-best scores and attention
sheets and the export CLI's ``.pth`` against the JAX package's, and
Show-and-Tell's BatchNorm layers, trunks, logits and train steps, and the
int8 trunk: one int8 conv per geometry, the quantized weights and scales,
each trunk's features over the JAX package's calibrated tree, and the
cosine of each calibration against its fp32 trunk, and multi-device: the
port's DP=2, TP=2 and DP=2 x TP=2 train steps (gloo ranks on the CPU)
against the JAX meshes, 2 ranks against 1, Show-and-Tell's BatchNorm
statistics at DP=2, and the Captioner over 2 ranks. Not a test module: it
reports the numbers that the tests only bound.

It also holds ``to_jax_params``, the inverse of the port's
``ckpt.convert.from_jax_params``, which the training tests use to compare
the port's parameters and optimizer moments with the JAX package's trees.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
# the JAX meshes of the multi-device figures take up to 4 of 8 virtual CPU devices, as the tests do
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8").strip()
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
from show_and_tell_tpu_torch.ckpt.convert import to_jax_trainable  # noqa: E402
from show_and_tell_tpu_torch.ops import fused_attention as tfa  # noqa: E402
from show_and_tell_tpu_torch.ops import fused_decode_attention as tfda  # noqa: E402
from show_and_tell_tpu_torch.ops import lstm as tlstm  # noqa: E402

DT = {"f32": to.F32, "bf16": to.BF16}


def to_jax_params(sd):
    """A port state dict (or any dict keyed by its parameter names, such as
    the Adam moments) -> the JAX package's ``(trainable, frozen)`` trees as
    numpy arrays; ``frozen`` is None without encoder weights."""
    a = {k: v.detach().cpu().float().numpy() for k, v in sd.items()}
    trainable = to_jax_trainable({k: v for k, v in sd.items() if not k.startswith("encoder.")})
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


def serving():
    import tempfile

    import test_torch_port_sample as ts
    import test_torch_port_train as tt
    from show_and_tell_tpu import ckpt as jckpt
    from show_and_tell_tpu.decode import sample as jsample
    from show_and_tell_tpu.serve import Captioner as JCaptioner
    from show_and_tell_tpu.train import step as jstep
    from show_and_tell_tpu.utils import vocab as jvocab
    from show_and_tell_tpu_torch import ckpt
    from show_and_tell_tpu_torch.ckpt.convert import from_jax_params
    from show_and_tell_tpu_torch.config import Config
    from show_and_tell_tpu_torch.decode import sample
    from show_and_tell_tpu_torch.models.registry import build_model
    from show_and_tell_tpu_torch.serve import Captioner
    from show_and_tell_tpu_torch.train.step import make_train_state, make_train_step
    from show_and_tell_tpu_torch.utils import vocab as tvocab

    trainable, frozen = tm._jax_init(3)
    jcfg, cfg = tm.JConfig(**ts.SMALL), Config(**ts.SMALL)
    jcap = JCaptioner(jcfg, tm.jbuild(jcfg, tm.V), trainable, frozen, jvocab.Vocabulary.from_words(ts.WORDS),
                      bucket_sizes=(1, 2, 4))
    tcap = Captioner(cfg, build_model(cfg, tm.V, device="cpu"), from_jax_params(trainable, frozen),
                     tvocab.Vocabulary.from_words(ts.WORDS), device="cpu", bucket_sizes=(1, 2, 4))
    images = np.random.default_rng(9).integers(0, 256, (3, 40, 40, 3), dtype=np.uint8)
    want, got = jcap.caption_nbest(images), tcap.caption_nbest(images)
    row("caption_nbest fp32, 3 images x 3 beams", scores=max(abs(a[1] - b[1]) for w, g in zip(want, got)
                                                            for a, b in zip(w, g)))
    (_, want), (_, got) = jcap.caption_with_attention(images), tcap.caption_with_attention(images)
    row("caption_with_attention fp32, alphas [3, 8, 4]", alphas=float(np.abs(want - got).max()))
    logits = np.random.default_rng(5).standard_normal(50).astype(np.float32) * 2.0
    _, probs = ts._numpy_filtered(logits, **ts.KNOBS)
    tiled = np.tile(logits, (ts.N_DRAWS, 1))
    k = ts.KNOBS
    draws = {
        "port": sample._sample_from_logits(torch.Generator().manual_seed(0), torch.from_numpy(tiled),
                                           k["temperature"], k["top_k"], k["top_p"]).numpy(),
        "jax": np.asarray(jsample._sample_from_logits(jax.random.PRNGKey(0), jnp.asarray(tiled),
                                                      k["temperature"], k["top_k"], k["top_p"])),
    }
    row(f"sampling {ts.N_DRAWS} draws, V=50, {k}: total variation vs numpy",
        **{n: 0.5 * float(np.abs(np.bincount(d, minlength=50) / ts.N_DRAWS - probs).sum()) for n, d in draws.items()})
    for case in ("plain", "accum2", "ema"):
        jcfg, jm, trainable, frozen, cfg, _ = tm._pair(**tt.CASES[case])
        batches = [tt._batch(seed=20 + i) for i in range(4)]
        jstate = jstep.make_train_state(jcfg, jax.tree.map(jnp.asarray, trainable))
        jtrain = jstep.make_train_step(jm, jcfg, donate=False)
        for i in range(3):
            jstate, _ = jtrain(jstate, frozen, batches[i][0], tt.LR, 0.0, jax.random.PRNGKey(i))
        with tempfile.TemporaryDirectory() as d:
            jckpt.save_train_state(d, jstate)
            model = build_model(cfg, tm.V, device="cpu", generator=torch.Generator().manual_seed(99))
            state = ckpt.load_train_state(d, make_train_state(cfg, model))
        jstate, _ = jtrain(jstate, frozen, batches[3][0], tt.LR, 0.0, jax.random.PRNGKey(3))
        state, _ = make_train_step(model, cfg)(state, batches[3][1], tt.LR)
        diff = jax.tree.leaves(jax.tree.map(lambda w, g: float(np.abs(np.asarray(w) - g).max()),
                                            jstate.params, to_jax_trainable(state.params)))
        row(f"JAX state-last.msgpack + 1 step in the port [{case}]", params=max(diff))


def trainer():
    import tempfile

    import test_torch_port_trainer as ttr

    with tempfile.TemporaryDirectory() as root:
        tiny = ttr.make_tiny(root)
        for gate in ("val_loss", "cider"):
            jt, tt, jinfos, infos, losses = ttr.train_both(tiny, os.path.join(root, gate), gate)
            want, got = np.asarray(losses["jax"]), np.asarray(losses["torch"])
            figures = dict(step_loss_rel=float((np.abs(got - want) / np.abs(want)).max()),
                           params=ttr.params_diff(jax.device_get(jt.state.params), tt.model))
            if gate == "val_loss":  # the cider gate's val loss is injected
                figures["val_loss_rel"] = max(abs(infos["val_result_history"][k]["loss"] - v["loss"]) / abs(v["loss"])
                                              for k, v in jinfos["val_result_history"].items())
            row(f"Trainer vs JAX Trainer, 8 steps fp32, {gate} gate", **figures)


def front_door():
    """The HTTP server's n-best scores and attention sheet, and the export
    CLI's .pth, against the JAX package's (``tests/test_torch_port_http.py``
    and ``test_torch_port_cli.py``)."""
    import base64
    import io
    import tempfile

    from PIL import Image

    import test_torch_port_cli as tc
    import test_torch_port_http as th
    from show_and_tell_tpu_torch.cli import serve_http

    jcap, tcap = th.make_pair()
    images = np.stack([serve_http._decode_image(th.png_bytes(seed)) for seed in range(8)])
    want, got = jcap.caption_nbest(images), tcap.caption_nbest(images)
    row("caption_nbest fp32 at the HTTP tests' weights, 8 scenes x 2", scores=max(
        abs(a[1] - b[1]) for w, g in zip(want, got) for a, b in zip(w, g)))
    with th.serving("jax", jcap) as (jurl, _), th.serving("torch", tcap) as (turl, _):
        servers = {"jax": jurl, "torch": turl}
        answers = [th.both(servers, "/caption?nbest=1", th.png_bytes(seed)) for seed in range(8)]
        row("POST /caption?nbest=1, 8 scenes: scores as answered (4 places)", scores=max(
            abs(a["score"] - b["score"]) for x in answers for a, b in zip(x["jax"][1]["nbest"], x["torch"][1]["nbest"])))
        sheets = [th.both(servers, "/caption?attention=1", th.png_bytes(seed)) for seed in range(8)]
        pixels = [[np.asarray(Image.open(io.BytesIO(base64.b64decode(x[pkg][1]["attention_sheet_png_b64"]))), np.int16)
                   for pkg in ("jax", "torch")] for x in sheets]
        row("POST /caption?attention=1, 8 scenes: the sheets' grey levels", sheet=float(max(
            np.abs(j - t).max() for j, t in pixels)))
    with tempfile.TemporaryDirectory() as root:
        cwd = os.getcwd()
        os.chdir(root)  # the CLIs' logs
        try:
            paths = tc.export_both(tc.write_experiment(root)["flags"], root)
        finally:
            os.chdir(cwd)
        want, got = (torch.load(paths[pkg], weights_only=True) for pkg in ("jax", "torch"))
        row("cli.export_torch .pth vs the JAX CLI's, every key", pth=max(
            float((got[k] - want[k]).abs().max()) for k in want))


def show_tell():
    """Show-and-Tell: the BatchNorm layers, both trunks, the
    decoder's logits (and with the JAX cell in Pallas interpret mode) and
    three train steps."""
    import test_torch_port_encoders as te
    import test_torch_port_show_tell as ts
    from show_and_tell_tpu.models import encoders as jenc
    from show_and_tell_tpu.models import layers as jlayers
    from show_and_tell_tpu_torch.models import encoders as tenc
    from show_and_tell_tpu_torch.models import layers as tlayers

    rng = np.random.default_rng(1)
    p = te._bn_params(rng, 16)
    x = rng.normal(1, 3, (32, 16)).astype(np.float32)
    jy, jnew = jlayers.batch_norm_train(te._j(p), jnp.asarray(x))
    ty, tnew = tlayers.batch_norm_train(te._t(p), torch.from_numpy(x))
    row("batch_norm_train fp32 [32, 16]", y=_d(jy, ty), mean=_d(jnew["mean"], tnew["mean"]),
        var=_d(jnew["var"], tnew["var"]))
    row("batch_norm_inference fp32", y=_d(jlayers.batch_norm_inference(te._j(p), jnp.asarray(x)),
                                           tlayers.batch_norm_inference(te._t(p), torch.from_numpy(x))))
    for name, size in te.SIZES.items():
        jtree = te.jax_trunk(name, te.fake_torchvision(name))
        img = np.random.default_rng(4).random((1, size, size, 3)).astype(np.float32)
        want = np.asarray(jenc.ENCODERS[name][1](jtree, jnp.asarray(img)))
        got = tenc.encoder_apply(name)(te.port_model_trunk(name, jtree), torch.from_numpy(img))
        row(f"{name} features at {size} px, B=1, fp32 (/ max|f|)", rel=_d(want, got) / np.abs(want).max())
    for layers in (1, 2):
        jm, trainable, _, stats, cfg, m = ts._pair(num_layers=layers)
        jb, tb = ts._batch(seed=2)
        jfe, _ = jm.encode(trainable, stats, jb["features"], train=False)
        want, _ = jm.decode_train(trainable, jfe, jb["captions"], jb["lengths"])
        with torch.no_grad():
            got, _ = m.decode_train(m.encode(tb["features"], train=False)[0], tb["captions"], tb["lengths"])
        row(f"show_tell decode_train logits, {layers} layer(s), fp32", logits=_d(want, got))
    jm, trainable, _, stats, cfg, m = ts._pair(hidden_size=128, num_layers=2)
    jb, tb = ts._batch(seed=3)
    jlstm.set_pallas_enabled(True, interpret=True)
    try:
        jfe, _ = jm.encode(trainable, stats, jb["features"], train=False)
        want, _ = jm.decode_train(trainable, jfe, jb["captions"], jb["lengths"])
    finally:
        jlstm.set_pallas_enabled(None)
    with torch.no_grad():
        got, _ = m.decode_train(m.encode(tb["features"], train=False)[0], tb["captions"], tb["lengths"])
    row("show_tell logits, H=128, JAX cell in Pallas interpret", logits=_d(want, got))
    jstate, state, metrics, _ = ts.train_both(num_layers=2)
    want = {k: np.asarray(v) for k, v in ts.from_jax_trainable(jstate.params).items()}
    row("show_tell 3 train steps (2 layers): loss rel, params, stats",
        loss=max(abs(float(t["loss"]) / float(j["loss"]) - 1) for j, t in metrics),
        params=max(_d(w, state.params[k].detach()) for k, w in want.items() if k != "proj.b"),
        proj_b=_d(want["proj.b"], state.params["proj.b"].detach()),
        stats=max(_d(jstate.batch_stats[k], state.batch_stats[k]) for k in ("mean", "var")))


def int8():
    """The int8 trunk: one conv per geometry (fp32 outputs in ulps), the
    int8 weights (any leaf that differs) and the activation scales (the
    largest relative difference), the features of the port's trunk over the
    JAX package's tree, and one minus each calibration's cosine against its
    fp32 trunk."""
    import test_torch_port_quantize as tq_test
    from show_and_tell_tpu.models import quantize as jq
    from show_and_tell_tpu_torch.ckpt.convert import from_jax_quantized
    from show_and_tell_tpu_torch.models import quantize as tq

    worst = 0
    for kh, kw, stride, pad in tq_test.GEOMETRIES:
        jtree, x = tq_test._conv_case(kh, kw, seed=kh * 10 + kw + stride)
        want = np.asarray(jq._qconv_s(jtree, jnp.asarray(x), stride=stride,
                                      padding=[(pad[0], pad[0]), (pad[1], pad[1])]))
        got = tq_test._port_conv(from_jax_quantized(jtree), x, stride, pad)
        worst = max(worst, int(np.abs(want.view(np.int32).astype(np.int64) - got.view(np.int32)).max()))
    row(f"int8 conv, {len(tq_test.GEOMETRIES)} geometries: fp32 output, ulps", ulps=worst)
    for name in ("vgg16", "resnet152", "inception_v3"):
        t = tq_test._trunk(name)
        want = from_jax_quantized(t["jq"])
        sx = differ = 0
        for path, w, g in tq_test.leaves(want, t["tq"]):
            if path.endswith(".sx"):
                sx = max(sx, abs(float(g) - float(w)) / float(w))
            else:
                differ += not torch.equal(g, w)
        feats = tq.backbone_features_q(want, torch.from_numpy(t["x"]))
        x = torch.from_numpy(t["x"])
        row(f"int8 {name} at {tq_test.SIZES[name]} px, B=2: weights, sx, features",
            wq_sw_b_differ=differ, sx_rel=sx, feat_rel=tq_test.rel(t["jfeat"], feats.numpy()),
            one_minus_cos_port=1 - tq.feature_agreement(t["ttree"], t["tq"], x),
            one_minus_cos_jax=1 - jq.feature_agreement(t["jtree"], t["jq"], jnp.asarray(t["x"])))


def parallel():
    """Multi-device: the train steps of each mesh against the JAX mesh's
    (losses relative, params of scale), each 2-rank case against one
    process, the BatchNorm statistics, and the Captioner's captions."""
    import tempfile

    import test_torch_port_parallel as tp
    import torch_port_ranks as ranks

    trainable, frozen, sat = tp._sat_weights()
    _, st_trainable, st_stats, st = tp._st_weights()
    cases = [tp._case(tp.SAT, tm.V, sat, tp._batch(tm.V)), tp._case(tp.SAT, tm.V, sat, tp._batch(tm.V), mp=2),
             tp._case(tp.SAT, tm.V, sat, tp._batch(tm.V, images=True), trunk=True),
             tp._case(tp.ST, tp.tst.V, st, tp._batch(tp.tst.V, features=(tp.tst.F,)))]
    with tempfile.TemporaryDirectory() as tmp:
        two = ranks.run("train", 2, os.path.join(tmp, "2"), {"cases": cases})[0]
        four = ranks.run("train", 4, os.path.join(tmp, "4"), {"cases": cases[1:2]})[0]
    for name, res in (("dp2", two[0]), ("tp2", two[1]), ("dp2xtp2", four[0])):
        n, mp = tp.MESHES[name]
        losses, params, _ = tp._jax_run(tp.SAT, tm.V, trainable, frozen, None, tp._batch(tm.V), n, mp)
        row(f"parallel {name} vs the JAX mesh, 3 steps", loss_rel=float(
            np.abs(np.array(res["losses"]) - losses).max() / np.abs(losses).max()), params=tp._rel(res["params"], params))
    for i, label in enumerate(("dp2 features", "tp2 features", "dp2 images", "show_tell dp2")):
        one = ranks.train_case(dict(cases[i], mp=1), 1)
        row(f"parallel {label}: 2 ranks vs 1", loss_rel=float(
            np.abs(np.array(two[i]["losses"]) - one["losses"]).max() / np.abs(one["losses"]).max()),
            params=tp._rel(two[i]["params"], one["params"]),
            proj_b=float(np.abs(two[i]["params"]["proj.b"] - one["params"]["proj.b"]).max()) if i == 3 else 0.0)
    one = ranks.train_case(dict(cases[3], mp=1), 1)
    _, _, jstats = tp._jax_run(tp.ST, tp.tst.V, st_trainable, None, st_stats, cases[3]["batch"], 2, 1)
    row("parallel show_tell dp2 BatchNorm stats (of scale)", **{
        f"{k}_vs_{w}": float(np.abs(two[3]["stats"][k] - ref[k]).max() / np.abs(ref[k]).max())
        for k in ("mean", "var") for w, ref in (("one", one["stats"]), ("jax", jstats))})


def main():
    print(f"jax {jax.__version__}, torch {torch.__version__}, CPU")
    cell()
    attention()
    variants()
    functions()
    model()
    training()
    serving()
    trainer()
    front_door()
    show_tell()
    int8()
    parallel()


if __name__ == "__main__":
    main()
