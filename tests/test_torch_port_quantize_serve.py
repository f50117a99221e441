"""PyTorch port, the int8 trunk's callers on the CPU: the models'
``backbone_features``, the ``Captioner`` (calibration, warmup, a shared
calibration file), the eval driver and the training step, and the
checkpoints, which do not carry the int8 tree.

The JAX ``Captioner`` and the port's serve one JAX-calibrated int8 VGG16
tree (``ckpt.convert.from_jax_quantized``) under numpy-seeded weights in
fp32: their captions must be identical. The other tests mirror
``tests/test_quantize.py`` on the port alone. The Trainer and
``cli.evaluate`` on the int8 trunk are held in
``tests/test_torch_port_trainer.py``, ``cli.serve_http --warmup_calib_dir``
in ``tests/test_torch_port_http.py``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_quantize import vgg_tree
from show_and_tell_tpu.config import Config as JConfig
from show_and_tell_tpu.data.transforms import eval_transform as jeval_transform
from show_and_tell_tpu.models import quantize as jq
from show_and_tell_tpu.models.registry import build_model as jbuild
from show_and_tell_tpu.serve import Captioner as JCaptioner
from show_and_tell_tpu.utils.vocab import Vocabulary as JVocabulary
from show_and_tell_tpu_torch import ckpt
from show_and_tell_tpu_torch.ckpt import torch_export
from show_and_tell_tpu_torch.ckpt.convert import from_jax_params, from_jax_quantized
from show_and_tell_tpu_torch.config import Config
from show_and_tell_tpu_torch.data.transforms import eval_transform
from show_and_tell_tpu_torch.evalsuite.driver import evaluation
from show_and_tell_tpu_torch.models import quantize as tq
from show_and_tell_tpu_torch.models.registry import build_model
from show_and_tell_tpu_torch.serve import Captioner
from show_and_tell_tpu_torch.train.step import make_train_state, make_train_step
from show_and_tell_tpu_torch.utils.vocab import Vocabulary

WORDS = [f"w{i}" for i in range(26)]
V = len(WORDS) + 4
SERVE = dict(embed_size=16, hidden_size=24, crop_size=32, max_decode_len=6, beam_size=3)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The file's tiny convolutions and steps on one thread: under a
    parallel test run, more only spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _uint8(n, seed, size=256):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def _scenes(n, seed):
    """Images of one random colour each under noise: trunk features that
    differ from image to image."""
    rng = np.random.default_rng(seed)
    return np.clip(rng.integers(0, 256, (n, 1, 1, 3)) + rng.normal(0, 30, (n, 256, 256, 3)), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def int8_pair():
    """JAX and port Captioners, fp32, over one set of numpy-seeded weights
    and one int8 VGG16 tree calibrated by the JAX package on 4 images. The
    initial state and the context's head projection are scaled by 16, so
    that the captions vary with the image."""
    jcfg = JConfig(**SERVE)
    jm = jbuild(jcfg, V)
    rng = np.random.default_rng(1)

    def fill(leaf):
        bound = 4.0 / np.sqrt(leaf.shape[0])
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    trainable = jax.tree.map(fill, jax.eval_shape(jm.init, jax.random.PRNGKey(0))[0])
    trainable["classifier"]["b"][Vocabulary.from_words(WORDS)("<end>")] -= 3.0
    for k in ("init_h", "init_c", "c2o"):
        trainable[k]["w"] *= 16.0
    frozen = vgg_tree(seed=1)
    calib = _scenes(4, seed=2)
    jtree = jq.quantize_vgg16(frozen, jeval_transform(jnp.asarray(calib), SERVE["crop_size"]))
    jcap = JCaptioner(jcfg, jm, trainable, jtree, JVocabulary.from_words(WORDS), bucket_sizes=(4,))
    cfg = Config(**SERVE, quantize_backbone=True)
    model = build_model(cfg, V, device="cpu")
    model.load_state_dict(from_jax_params(trainable, frozen))
    model.quantized = from_jax_quantized(jtree)
    tcap = Captioner(cfg, model, None, Vocabulary.from_words(WORDS), device="cpu", bucket_sizes=(4,))
    return jcap, tcap


@pytest.mark.parametrize("mode", ["beam", "greedy"])
def test_captioner_int8_matches_jax(int8_pair, mode):
    """Five held-out images (chunks of 4, the last padded): the captions of
    the two Captioners over one int8 tree, identical in fp32; no
    recalibration."""
    jcap, tcap = int8_pair
    tree = tcap.model.quantized
    imgs = _scenes(5, seed=3)
    want = jcap.caption_images(imgs, mode=mode)
    got = tcap.caption_images(imgs, mode=mode)
    assert got == want and len(set(got)) > 1
    assert tcap.model.quantized is tree


def test_backbone_features_dispatch_to_int8_in_fp32(int8_pair):
    """With ``quantized`` set, the model's ``backbone_features`` is the int8
    trunk, in fp32 whatever the compute dtype; without, the float trunk."""
    _, tcap = int8_pair
    x = eval_transform(torch.from_numpy(_uint8(2, seed=4)), SERVE["crop_size"])
    want = tq.backbone_features_q(tcap.model.quantized, x)
    m16 = build_model(Config(**SERVE, dtype="bfloat16"), V, device="cpu")
    assert m16.backbone_features(x).dtype == torch.bfloat16
    m16.quantized = tcap.model.quantized
    got = m16.backbone_features(x)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_checkpoints_do_not_carry_the_int8_tree(int8_pair, tmp_path):
    """A model with its int8 tree writes ``model-best.pt``, ``state-last.pt``
    and the reference export with the keys and sizes of the same model
    without it, and ``state_dict()`` holds no int8 tensor."""
    _, tcap = int8_pair
    cfg, q = tcap.cfg, tcap.model
    plain = copy.deepcopy(q)
    plain.quantized = None
    assert q.quantized is not None
    for m, d in ((q, "q"), (plain, "f")):
        ckpt.save_best(str(tmp_path / d), ckpt.trainable_state_dict(m), m.batch_stats, {})
        ckpt.save_train_state(str(tmp_path / d), make_train_state(cfg, m))
        torch_export.export_checkpoint(cfg, m.state_dict(), str(tmp_path / d / "model.pth"))
    assert all(v.dtype == torch.float32 for v in q.state_dict().values())
    for name in ("model-best.pt", "state-last.pt", "model.pth"):
        got, want = (_layout(torch.load(tmp_path / d / name, weights_only=True)) for d in ("q", "f"))
        assert got == want, name
        assert (tmp_path / "q" / name).stat().st_size == (tmp_path / "f" / name).stat().st_size


def _layout(obj):
    """A checkpoint's structure: its keys, with each tensor's dtype and shape."""
    if isinstance(obj, dict):
        return {k: _layout(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_layout(v) for v in obj]
    return (obj.dtype, tuple(obj.shape)) if torch.is_tensor(obj) else obj


# --- mirrors of tests/test_quantize.py ------------------------------------------------


def test_captioner_quantized_matches_f32_captions():
    """Train the tiny colour model on fp32 trunk features, then caption with
    and without the int8 trunk: the same captions."""
    colors = {"red": (200, 30, 30), "green": (30, 200, 30), "blue": (30, 30, 200), "white": (230, 230, 230)}
    names = list(colors)
    vocab = Vocabulary.from_words(["a", "ball"] + names)
    cfg = Config(embed_size=24, hidden_size=48, crop_size=64, max_decode_len=4, beam_size=2)
    rng = np.random.default_rng(0)
    imgs = np.stack([
        np.clip(np.array(colors[names[i % 4]], np.float32)[None, None, :] + rng.normal(0, 10, (256, 256, 3)),
                0, 255).astype(np.uint8)
        for i in range(16)
    ])
    caps, lens = vocab.encode_batch([["a", names[i % 4], "ball"] for i in range(16)], 6)
    cap = Captioner.from_checkpoint(cfg, None, vocab, device="cpu", bucket_sizes=(16,))
    feats = cap.model.backbone_features(eval_transform(torch.from_numpy(imgs), cfg.crop_size))
    state = make_train_state(cfg, cap.model)
    step = make_train_step(cap.model, cfg)
    batch = {"features": feats, "captions": torch.from_numpy(caps), "lengths": torch.from_numpy(lens)}
    for _ in range(150):
        state, metrics = step(state, batch, 5e-3)
    assert float(metrics["loss"]) < 0.2

    f32_caps = cap.caption_images(imgs, mode="beam")
    expected = [f"a {names[i % 4]} ball" for i in range(16)]
    assert sum(c == e for c, e in zip(f32_caps, expected)) >= 14
    qcap = Captioner(cfg.replace(quantize_backbone=True), copy.deepcopy(cap.model), None, vocab, device="cpu",
                     bucket_sizes=(16,))
    q_caps = qcap.caption_images(imgs, mode="beam")
    assert tq.is_quantized(qcap.model.quantized)  # the first batch calibrated it
    assert cap.model.quantized is None
    assert q_caps == f32_caps
    tree = qcap.model.quantized
    assert qcap.caption_images(imgs[:2], mode="greedy") and qcap.model.quantized is tree  # no recalibration


def test_evaluation_with_quantized_backbone():
    vocab = Vocabulary.from_words(["a", "dog", "runs", "ball"])
    cfg = Config(embed_size=16, hidden_size=24, crop_size=64, max_decode_len=4, beam_size=2)
    model = build_model(cfg, len(vocab), device="cpu")
    B = 4
    imgs = _uint8(B, seed=0)
    caps, lens = vocab.encode_batch([["a", "dog", "runs"]] * B, 6)
    batches = [{"captions": caps, "lengths": lens, "imgids": list(range(B)),
                "cocoids": list(range(100, 100 + B)), "images": imgs}]
    model.quantized = tq.quantize_vgg16(model.frozen_tree(), eval_transform(torch.from_numpy(imgs), cfg.crop_size))
    before = tq.GEMMS["int_mm"]
    val_loss, preds, _ = evaluation(model, cfg, batches, vocab, mode="greedy", ann_file=None)
    assert np.isfinite(val_loss) and tq.GEMMS["int_mm"] > before
    assert len(preds) == B and all("caption" in p for p in preds)


def test_train_step_with_quantized_backbone():
    vocab = Vocabulary.from_words(["a", "dog", "runs"])
    cfg = Config(embed_size=16, hidden_size=24, crop_size=64, max_decode_len=5)
    model = build_model(cfg, len(vocab), device="cpu")
    imgs = _uint8(4, seed=0)
    model.quantized = tq.quantize_vgg16(model.frozen_tree(), eval_transform(torch.from_numpy(imgs), cfg.crop_size))
    caps, lens = vocab.encode_batch([["a", "dog", "runs"]] * 4, 6)
    state = make_train_state(cfg, model)
    step = make_train_step(model, cfg)
    batch = {"images": torch.from_numpy(imgs), "captions": torch.from_numpy(caps), "lengths": torch.from_numpy(lens)}
    before = {k: v.clone() for k, v in state.params.items()}
    new_state, metrics = step(state, batch, 1e-3, generator=torch.Generator().manual_seed(1))
    assert np.isfinite(float(metrics["loss"])) and new_state.step == 1
    assert any(not torch.equal(new_state.params[k], before[k]) for k in before)


def test_show_tell_captioner_quantized_smoke():
    cfg = Config(model="show_tell", embed_size=16, hidden_size=24, crop_size=64, max_decode_len=4, beam_size=2,
                 quantize_backbone=True)
    vocab = Vocabulary.from_words(["a", "dog", "runs"])
    cap = Captioner.from_checkpoint(cfg, None, vocab, device="cpu", bucket_sizes=(2,))
    caps = cap.caption_images(_uint8(2, seed=0), mode="greedy")
    assert len(caps) == 2
    assert tq.is_quantized(cap.model.quantized)
    assert "qlayers" in cap.model.quantized  # the ResNet recipe, not the VGG one


def test_warmup_never_calibrates_on_dummies(tmp_path):
    """No calibration source: warmup leaves the trunk float and the first
    real batch calibrates. ``calib_images``: warmup calibrates. A file at
    ``quantized_backbone_path``: warmup loads it, and a second Captioner on
    the path serves the same scales."""
    vocab = Vocabulary.from_words(["a", "ball"])
    cfg = Config(embed_size=16, hidden_size=24, crop_size=32, max_decode_len=3, beam_size=2, quantize_backbone=True)
    cap = Captioner.from_checkpoint(cfg, None, vocab, device="cpu", bucket_sizes=(2,))
    cap.warmup(modes=("greedy", "nbest", "attention"))
    assert cap.model.quantized is None  # zeros never calibrate
    imgs = _uint8(2, seed=0)
    cap.caption_images(imgs, mode="greedy")  # the first real batch calibrates
    assert tq.is_quantized(cap.model.quantized)

    path = str(tmp_path / "cal.pt")
    cap2 = Captioner.from_checkpoint(cfg.replace(quantized_backbone_path=path), None, vocab, device="cpu",
                                     bucket_sizes=(2,))
    cap2.warmup(modes=("greedy",), calib_images=imgs)
    assert tq.is_quantized(cap2.model.quantized)  # calibrated at startup, and saved
    cap3 = Captioner.from_checkpoint(cfg.replace(quantized_backbone_path=path), None, vocab, device="cpu",
                                     bucket_sizes=(2,))
    cap3.warmup(modes=("greedy",))
    assert all(torch.equal(a["sx"], b["sx"]) for a, b in zip(cap3.model.quantized["qconvs"],
                                                            cap2.model.quantized["qconvs"]))
