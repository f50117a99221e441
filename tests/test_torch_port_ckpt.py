"""PyTorch port, checkpoints in and out, against the JAX package on the CPU.

- A JAX experiment directory (``model-best.msgpack`` written by the JAX
  ``ckpt.save_best``) and a torchvision-keyed trunk serve the same fp32
  captions through both ``Captioner.from_checkpoint``s; so do a
  reference-format ``.pth`` written by the JAX exporter and the port's own
  ``model-best.pt``.
- The flax msgpack reader returns chunked arrays, bfloat16 and scalars bit
  for bit.
- A JAX ``state-last.msgpack`` resumed in the port takes the same step as
  the JAX package; the port's own train state resumes bit for bit, with the
  JAX package's three EMA rules.
- The reference-format export equals the JAX exporter's key for key.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_model as tpm
import test_torch_port_train as ttr
from show_and_tell_tpu import ckpt as jckpt
from show_and_tell_tpu.ckpt import torch_export as jexport
from show_and_tell_tpu.config import Config as JConfig
from show_and_tell_tpu.models.encoders import load_torch_encoder as jload_encoder
from show_and_tell_tpu.serve import Captioner as JCaptioner
from show_and_tell_tpu.train import step as jstep
from show_and_tell_tpu.utils import vocab as jvocab
from show_and_tell_tpu_torch import ckpt
from show_and_tell_tpu_torch.ckpt import torch_export, torch_import
from show_and_tell_tpu_torch.ckpt.convert import from_jax_params, from_jax_trainable, to_jax_trainable
from show_and_tell_tpu_torch.ckpt.jax_msgpack import load_jax_best, read_msgpack
from show_and_tell_tpu_torch.config import Config
from show_and_tell_tpu_torch.models.encoders import load_torch_encoder, to_torch_vgg16
from show_and_tell_tpu_torch.models.registry import build_model
from show_and_tell_tpu_torch.serve import Captioner
from show_and_tell_tpu_torch.train.step import make_train_state, make_train_step
from show_and_tell_tpu_torch.utils import vocab as tvocab

SMALL = dict(tpm.SMALL, beam_size=3)
WORDS = [f"w{i}" for i in range(tpm.V - 4)]
BUCKETS = (1, 2, 4)
LR = ttr.LR


def _images(seed=7, n=3):
    return np.random.default_rng(seed).integers(0, 256, (n, 40, 40, 3), dtype=np.uint8)


def _weights(seed=4):
    """The JAX model's random trees at the small widths, as numpy."""
    return jax.tree.map(np.copy, tpm._jax_init(seed))


def _write_trunk(frozen, path):
    """The JAX trunk as a torchvision VGG16 state dict."""
    convs = [{"w": torch.from_numpy(np.ascontiguousarray(conv["w"].transpose(3, 2, 0, 1))),
              "b": torch.from_numpy(np.array(conv["b"]))} for conv in frozen["convs"]]
    torch.save(to_torch_vgg16({"convs": convs}), path)
    return str(path)


def _pair(jcfg, cfg, expr_dir):
    jcap = JCaptioner.from_checkpoint(jcfg, expr_dir, jvocab.Vocabulary.from_words(WORDS), bucket_sizes=BUCKETS)
    tcap = Captioner.from_checkpoint(cfg, expr_dir, tvocab.Vocabulary.from_words(WORDS), device="cpu",
                                     bucket_sizes=BUCKETS)
    return jcap, tcap


@pytest.fixture(scope="module")
def jax_experiment(tmp_path_factory):
    """A JAX experiment directory, the trunk file, and both Captioners over
    them."""
    d = tmp_path_factory.mktemp("jax_experiment")
    trainable, frozen = _weights()
    jckpt.save_best(str(d), trainable, None, {"best_val_score": np.float32(0.75), "iter": np.int64(3)})
    enc = _write_trunk(frozen, d / "vgg16.pth")
    jcap, tcap = _pair(JConfig(**SMALL, encoder_weights=enc), Config(**SMALL, encoder_weights=enc), str(d))
    return d, enc, trainable, frozen, jcap, tcap


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_jax_checkpoint_serves_jax_captions(jax_experiment, mode):
    *_, jcap, tcap = jax_experiment
    images = _images()
    want = jcap.caption_images(images, mode=mode)
    assert tcap.caption_images(images, mode=mode) == want
    assert any(want), "random weights should still emit some words"


def test_from_checkpoint_loads_every_weight(jax_experiment, caplog):
    """The decoder is the checkpoint's, the trunk the torchvision file's,
    and the Captioner reports which file it read."""
    d, enc, trainable, frozen, _, tcap = jax_experiment
    sd = tcap.model.state_dict()
    for k, v in from_jax_params(trainable, frozen).items():
        assert torch.equal(sd[k], v), k
    with caplog.at_level("INFO"):
        Captioner.from_checkpoint(Config(**SMALL, encoder_weights=enc), str(d),
                                  tvocab.Vocabulary.from_words(WORDS), device="cpu")
    assert "model-best.msgpack" in caplog.text


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_port_checkpoint_round_trips(jax_experiment, tmp_path, mode):
    """The port's model-best.pt of the same weights serves the JAX captions,
    and its infos-best.json is the JAX package's, byte for byte."""
    d, enc, _, _, jcap, tcap = jax_experiment
    infos = {"best_val_score": np.float32(0.75), "iter": np.int64(3)}
    ckpt.save_best(str(tmp_path), ckpt.trainable_state_dict(tcap.model), None, infos)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["infos-best.json", "model-best.pt"]
    assert (tmp_path / "infos-best.json").read_text() == (d / "infos-best.json").read_text()
    back = Captioner.from_checkpoint(Config(**SMALL, encoder_weights=enc), str(tmp_path),
                                     tvocab.Vocabulary.from_words(WORDS), device="cpu", bucket_sizes=BUCKETS)
    images = _images(seed=9, n=5)
    assert back.caption_images(images, mode=mode) == jcap.caption_images(images, mode=mode)


def test_infos_json_matches_jax(tmp_path):
    infos = {"best_val_score": np.float64(1.25), "loss_history": {"3": np.float32(2.5)},
             "lr": np.array([1e-3, 8e-4]), "t": torch.tensor(4)}
    jinfos = dict(infos, t=4)
    ckpt.save_infos(str(tmp_path / "t"), infos)
    jckpt.save_infos(str(tmp_path / "j"), jinfos)
    assert (tmp_path / "t" / "infos.json").read_text() == (tmp_path / "j" / "infos.json").read_text()
    assert ckpt.load_infos(str(tmp_path / "t")) == jckpt.load_infos(str(tmp_path / "j"))
    assert ckpt.load_infos(str(tmp_path / "none")) is None
    with pytest.raises(TypeError, match="not JSON-serializable"):
        ckpt.save_infos(str(tmp_path / "bad"), {"x": object()})
    assert not list((tmp_path / "bad").glob("*.json"))


def test_from_checkpoint_refusals_and_warnings(tmp_path, caplog):
    vocab = tvocab.Vocabulary.from_words(WORDS)
    with pytest.raises(FileNotFoundError, match="no model-best checkpoint"):
        Captioner.from_checkpoint(Config(**SMALL), str(tmp_path), vocab, device="cpu")
    assert "without encoder_weights" in caplog.text
    # quantize_backbone: the int8 trunk, calibrated on the first real batch
    # and read again from quantized_backbone_path
    qcfg = Config(**SMALL, quantize_backbone=True, quantized_backbone_path=str(tmp_path / "int8.pt"))
    cap = Captioner.from_checkpoint(qcfg, None, vocab, device="cpu", bucket_sizes=(2,))
    assert cap.model.quantized is None
    images = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    assert len(cap.caption_images(images, mode="greedy")) == 2 and "qconvs" in cap.model.quantized
    again = Captioner.from_checkpoint(qcfg, None, vocab, device="cpu", bucket_sizes=(2,))
    again.caption_images(images[:1], mode="greedy")
    assert torch.equal(again.model.quantized["qconvs"][-1]["sx"], cap.model.quantized["qconvs"][-1]["sx"])
    # ResNet-152: a torchvision file reads as the JAX
    # package reads it
    from show_and_tell_tpu_torch.models.encoders import init_encoder, to_torch_resnet152

    torch.save(to_torch_resnet152(init_encoder("resnet152", torch.Generator().manual_seed(0))),
               tmp_path / "r.pth")
    got = torch_import.encoder_state_dict(load_torch_encoder("resnet152", str(tmp_path / "r.pth")))
    want = from_jax_params({}, jload_encoder("resnet152", str(tmp_path / "r.pth")))
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)


def test_from_checkpoint_without_a_directory_is_the_seeded_init():
    vocab = tvocab.Vocabulary.from_words(WORDS)
    a = Captioner.from_checkpoint(Config(**SMALL), None, vocab, device="cpu").model.state_dict()
    b = Captioner.from_checkpoint(Config(**SMALL), None, vocab, device="cpu").model.state_dict()
    c = Captioner.from_checkpoint(Config(**SMALL, random_seed=5), None, vocab, device="cpu").model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])


def test_load_torch_encoder_matches_jax(jax_experiment):
    _, enc, _, frozen, _, _ = jax_experiment
    got = load_torch_encoder("vgg16", enc)["convs"]
    want = jload_encoder("vgg16", enc)["convs"]
    for g, w, f in zip(got, want, frozen["convs"]):
        np.testing.assert_array_equal(g["w"].numpy(), np.asarray(w["w"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(np.asarray(w["w"]), f["w"])
        np.testing.assert_array_equal(g["b"].numpy(), np.asarray(w["b"]))


def test_to_torch_vgg16_round_trips(tmp_path):
    """A model's trunk written as a torchvision file and read back by
    ``load_torch_encoder`` and ``load_trunk`` into another model is the same
    trunk, bit for bit."""
    cfg = Config(**SMALL)
    a = build_model(cfg, tpm.V, device="cpu", generator=torch.Generator().manual_seed(1))
    b = build_model(cfg, tpm.V, device="cpu", generator=torch.Generator().manual_seed(2))
    sd = to_torch_vgg16(a.encoder)
    assert sorted(int(k.split(".")[1]) for k in sd if k.endswith("weight")) == [
        0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26]
    torch.save(sd, tmp_path / "vgg16.pth")
    before = {k: v.clone() for k, v in b.state_dict().items()}
    assert not torch.equal(before["encoder.convs.0.w"], a.state_dict()["encoder.convs.0.w"])
    trunk = torch_import.trunk_state_dict(load_torch_encoder("vgg16", str(tmp_path / "vgg16.pth"))["convs"])
    ckpt.load_trunk(b, trunk, "vgg16.pth")
    want, got = a.state_dict(), b.state_dict()
    for k in want:
        assert torch.equal(got[k], want[k] if k.startswith("encoder.") else before[k]), k


def test_load_trunk_needs_every_conv():
    """A trunk short of a conv, or with a wrong shape, is refused before
    anything is copied."""
    model = build_model(Config(**SMALL), tpm.V, device="cpu", generator=torch.Generator().manual_seed(1))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trunk = {n: torch.zeros_like(p) for n, p in model.named_parameters() if n.startswith("encoder.")}
    short = {k: v for k, v in trunk.items() if not k.startswith("encoder.convs.11.")}
    with pytest.raises(ValueError, match="missing"):
        ckpt.load_trunk(model, short, "short")
    bad = dict(trunk, **{"encoder.convs.0.b": torch.zeros(3)})
    with pytest.raises(ValueError, match="shapes differ"):
        ckpt.load_trunk(model, bad, "bad")
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


# --- the flax msgpack reader ------------------------------------------------


@pytest.mark.parametrize("chunk", [None, 100], ids=["whole", "chunked"])
def test_msgpack_reader_bit_for_bit(tmp_path, monkeypatch, chunk):
    """float32, bfloat16 (no numpy dtype: uint16 bits viewed as bf16),
    int32 and numpy scalars, whole and, with flax's chunk size lowered to
    100 bytes, in chunks."""
    import msgpack
    from flax import serialization

    if chunk is not None:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((7, 9)).astype(np.float32)
    bf = jnp.asarray(rng.standard_normal((5, 11)), jnp.bfloat16)
    ints = rng.integers(-5, 5, (3, 4, 5), dtype=np.int32)
    tree = {"f32": f32, "bf16": bf, "ints": ints, "scalar": np.float32(2.5), "count": np.int32(7),
            "none": None, "nested": {"0": f32[:2]}}
    path = tmp_path / "t.msgpack"
    path.write_bytes(serialization.to_bytes(tree))
    raw = msgpack.unpackb(path.read_bytes(), ext_hook=lambda c, d: None, raw=False)
    assert isinstance(raw["f32"], dict) == (chunk is not None)  # a chunked map, or an ext array
    got = read_msgpack(str(path))
    assert torch.equal(got["f32"], torch.from_numpy(f32))
    assert got["bf16"].dtype == torch.bfloat16 and got["bf16"].shape == (5, 11)
    assert np.array_equal(got["bf16"].view(torch.int16).numpy().view(np.uint16), np.asarray(bf).view(np.uint16))
    assert torch.equal(got["ints"], torch.from_numpy(ints))
    assert got["scalar"] == 2.5 and got["count"] == 7 and got["none"] is None
    assert torch.equal(got["nested"]["0"], torch.from_numpy(f32[:2]))


def test_chunked_checkpoint_reads_bit_for_bit(tmp_path, monkeypatch):
    """A model-best.msgpack whose arrays are all chunked gives the trainable
    state dict exactly."""
    from flax import serialization

    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    trainable, _ = _weights()
    jckpt.save_best(str(tmp_path), trainable, None, {})
    got, stats = load_jax_best(str(tmp_path / "model-best.msgpack"))
    assert stats is None
    want = from_jax_trainable(trainable)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# --- train states -----------------------------------------------------------


def _port_trees_close(want_tree, got_sd, atol):
    ttr._trees_close(want_tree, to_jax_trainable(got_sd), atol)


@pytest.mark.parametrize("case", ["plain", "accum2", "ema"])
def test_jax_train_state_resumes_in_the_port(tmp_path, case):
    """Three JAX steps, then state-last.msgpack; one more step by the JAX
    package, and one by the port from that file into a model of another
    init: params, Adam's moments and count, the accumulation state and the
    EMA agree within 1e-5."""
    jcfg, jm, trainable, frozen, cfg, _ = tpm._pair(**ttr.CASES[case])
    batches = [ttr._batch(seed=20 + i) for i in range(4)]
    jstate = jstep.make_train_state(jcfg, jax.tree.map(jnp.asarray, trainable))
    jtrain = jstep.make_train_step(jm, jcfg, donate=False)
    for i in range(3):
        jstate, _ = jtrain(jstate, frozen, batches[i][0], LR, 0.0, jax.random.PRNGKey(i))
    jckpt.save_train_state(str(tmp_path), jstate)
    jstate, _ = jtrain(jstate, frozen, batches[3][0], LR, 0.0, jax.random.PRNGKey(3))

    model = build_model(cfg, tpm.V, device="cpu", generator=torch.Generator().manual_seed(99))
    state = make_train_state(cfg, model)
    assert ckpt.load_train_state(str(tmp_path), state) is state
    assert state.step == 3
    state, _ = make_train_step(model, cfg)(state, batches[3][1], LR)
    assert state.step == int(jstate.step) == 4
    _port_trees_close(jstate.params, state.params, 1e-5)
    adam = ttr._adam_state(jstate.opt_state)
    assert state.opt_state["count"] == int(adam.count)
    _port_trees_close(adam.mu, state.opt_state["mu"], 1e-5)
    _port_trees_close(adam.nu, state.opt_state["nu"], 1e-5)
    if case == "accum2":
        assert state.opt_state["mini_step"] == int(jstate.opt_state.mini_step) == 0
        _port_trees_close(jstate.opt_state.acc_grads, state.opt_state["acc_grads"], 1e-5)
    if case == "ema":
        _port_trees_close(jstate.ema_params, state.ema_params, 1e-5)
    else:
        assert state.ema_params is None


def _fresh(cfg, sd, seed=0):
    model = build_model(cfg, tpm.V, device="cpu", generator=torch.Generator().manual_seed(seed))
    if sd is not None:
        model.load_state_dict(sd)
    return model, make_train_state(cfg, model), make_train_step(model, cfg)


def _state_tensors(state):
    out = {f"params/{k}": v for k, v in state.params.items()}
    for part in ("mu", "nu", "acc_grads"):
        out.update({f"{part}/{k}": v for k, v in state.opt_state.get(part, {}).items()})
    out.update({f"ema/{k}": v for k, v in (state.ema_params or {}).items()})
    return out


@pytest.mark.parametrize("case", ["plain", "accum2", "ema"])
def test_port_round_trip_equals_six_straight_steps(tmp_path, case):
    """3 steps, save, load into a model of another init, 3 more steps: every
    tensor of the state equal to 6 straight steps, and the model trains on
    the loaded parameters (the state's tensors are the model's)."""
    _, _, trainable, frozen, cfg, _ = tpm._pair(**ttr.CASES[case])
    sd = from_jax_params(trainable, frozen)
    batches = [ttr._batch(seed=30 + i)[1] for i in range(6)]
    _, straight, train = _fresh(cfg, sd)
    for b in batches:
        straight, _ = train(straight, b, LR)
    _, first, train = _fresh(cfg, sd)
    for b in batches[:3]:
        first, _ = train(first, b, LR)
    path = ckpt.save_train_state(str(tmp_path), first)
    assert path.endswith("state-last.pt") and not list(tmp_path.glob("*.tmp"))
    model, resumed, train = _fresh(cfg, None, seed=99)
    resumed = ckpt.load_train_state(str(tmp_path), resumed)
    params = dict(model.named_parameters())
    assert all(v is params[k] for k, v in resumed.params.items())
    for b in batches[3:]:
        resumed, _ = train(resumed, b, LR)
    want, got = _state_tensors(straight), _state_tensors(resumed)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert resumed.step == straight.step == 6
    assert resumed.opt_state["count"] == straight.opt_state["count"]
    assert resumed.opt_state.get("mini_step") == straight.opt_state.get("mini_step")


@pytest.mark.parametrize("resume_ema", [True, False], ids=["resume_ema", "resume_plain"])
@pytest.mark.parametrize("saved", ["ema", "none", "absent"])
def test_ema_load_rules(tmp_path, saved, resume_ema):
    """A file with an average, one saved without (None), and an older one
    without the field, each resumed with and without an EMA."""
    base = dict(SMALL)
    _, saver, train = _fresh(Config(**base, ema_decay=0.9 if saved == "ema" else 0.0), None)
    saver, _ = train(saver, ttr._batch(seed=40)[1], LR)
    ckpt.save_train_state(str(tmp_path), saver)
    if saved == "absent":
        blob = torch.load(tmp_path / "state-last.pt", weights_only=True)
        del blob["ema_params"]
        torch.save(blob, tmp_path / "state-last.pt")
    _, state, _ = _fresh(Config(**base, ema_decay=0.9 if resume_ema else 0.0), None, seed=99)
    state = ckpt.load_train_state(str(tmp_path), state)
    if not resume_ema:
        assert state.ema_params is None
        return
    want = saver.ema_params if saved == "ema" else saver.params
    if saved == "ema":
        assert not torch.equal(saver.ema_params["embed"], saver.params["embed"])
    for k, v in state.ema_params.items():
        assert torch.equal(v, want[k]) and v is not state.params[k], k


def test_train_state_refuses_another_accumulation(tmp_path):
    _, state, _ = _fresh(Config(**SMALL), None)
    ckpt.save_train_state(str(tmp_path), state)
    _, other, _ = _fresh(Config(**SMALL, grad_accum_steps=2), None)
    with pytest.raises(ValueError, match="accumulation"):
        ckpt.load_train_state(str(tmp_path), other)
    assert ckpt.load_train_state(str(tmp_path / "none"), other) is None


def test_copy_into_checks_every_name_and_shape_first():
    a = {"x": torch.zeros(2), "y": torch.zeros(3)}
    with pytest.raises(ValueError, match="missing"):
        ckpt.copy_into(a, {"x": torch.ones(2)}, "t")
    with pytest.raises(ValueError, match="shapes"):
        ckpt.copy_into(a, {"x": torch.ones(2), "y": torch.ones(4)}, "t")
    assert float(a["x"].sum()) == 0.0
    ckpt.copy_into(a, {"x": torch.ones(2), "y": torch.ones(3)}, "t")
    assert float(a["x"].sum() + a["y"].sum()) == 5.0


# --- reference-format .pth, in and out --------------------------------------


@pytest.fixture(scope="module")
def reference_pth(tmp_path_factory):
    """The JAX exporter's reference-format file of the same weights, served
    by both Captioners through ``cfg.torch_checkpoint``."""
    d = tmp_path_factory.mktemp("reference")
    trainable, frozen = _weights(seed=3)
    path = str(d / "model-best.pth")
    jexport.save_state_dict(jexport.export_show_attend_tell(trainable, frozen), path)
    jcap, tcap = _pair(JConfig(**SMALL, torch_checkpoint=path), Config(**SMALL, torch_checkpoint=path), None)
    return path, trainable, frozen, jcap, tcap


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_reference_checkpoint_serves_jax_captions(reference_pth, mode):
    *_, jcap, tcap = reference_pth
    images = _images(seed=11)
    want = jcap.caption_images(images, mode=mode)
    assert tcap.caption_images(images, mode=mode) == want
    assert any(want)


def test_reference_checkpoint_import_matches_the_weights(reference_pth, tmp_path, caplog):
    """Every weight lands where from_jax_params puts it; a DataParallel
    ``module.`` prefix is stripped; a decoder-only file keeps the trunk and
    warns."""
    path, trainable, frozen, _, tcap = reference_pth
    want = from_jax_params(trainable, frozen)
    sd = tcap.model.state_dict()
    for k in want:
        assert torch.equal(sd[k], want[k]), k
    full = torch.load(path, weights_only=True)
    wrapped = str(tmp_path / "wrapped.pth")
    torch.save({f"module.{k}": v for k, v in full.items()}, wrapped)
    t, trunk = torch_import.load_reference_checkpoint(wrapped)
    assert set(t) | set(trunk) == set(want)
    assert all(torch.equal(v, want[k]) for k, v in {**t, **trunk}.items())
    decoder_only = str(tmp_path / "decoder.pth")
    torch.save({k: v for k, v in full.items() if not k.startswith("encoder.")}, decoder_only)
    cap = Captioner.from_checkpoint(Config(**SMALL, torch_checkpoint=decoder_only), None,
                                    tvocab.Vocabulary.from_words(WORDS), device="cpu")
    assert "contains no encoder weights" in caplog.text
    got = cap.model.state_dict()
    assert torch.equal(got["lstm.w"], want["lstm.w"]) and not torch.equal(got["encoder.convs.0.w"],
                                                                           want["encoder.convs.0.w"])
    # a Show-and-Tell file reads as the JAX importer reads it
    from show_and_tell_tpu.ckpt import torch_import as jimport
    import test_torch_port_show_tell as tst

    _, st_trainable, _, st_stats = tst.jax_weights(tst.SMALL)
    st_path = str(tmp_path / "show_tell.pth")
    jexport.save_state_dict(jexport.export_show_tell(st_trainable, st_stats), st_path)
    jt, jstats, _ = jimport.load_reference_checkpoint(st_path, "show_tell")
    t, stats, st_trunk = torch_import.load_reference_checkpoint(st_path, "show_tell")
    assert st_trunk is None and all(torch.equal(t[k], v) for k, v in from_jax_trainable(jt).items())
    assert all(np.array_equal(stats[k].numpy(), np.asarray(jstats[k])) for k in ("mean", "var"))


@pytest.mark.parametrize("with_trunk", [True, False], ids=["full", "decoder"])
def test_export_matches_jax_key_for_key(tmp_path, with_trunk):
    trainable, frozen = _weights(seed=6)
    want = jexport.export_show_attend_tell(trainable, frozen if with_trunk else None)
    sd = from_jax_params(trainable, frozen) if with_trunk else from_jax_trainable(trainable)
    got = torch_export.export_show_attend_tell(sd)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k]), k
    # and back through the importer, bit for bit
    back, trunk = torch_import.import_show_attend_tell(got)
    assert (trunk is not None) == with_trunk
    for k, v in {**back, **(trunk or {})}.items():
        assert torch.equal(v, sd[k]), k
    path = str(tmp_path / "out.pth")
    torch_export.export_checkpoint(Config(**SMALL), sd, path)
    loaded = torch.load(path, weights_only=True)
    assert all(np.array_equal(loaded[k].numpy(), want[k]) for k in want)
    # Show-and-Tell: the file the JAX one-call export writes
    import test_torch_port_show_tell as tst

    _, st_trainable, _, st_stats, st_cfg, st_model = tst._pair()
    jexport.export_checkpoint(JConfig(**tst.SMALL), st_trainable, path, batch_stats=st_stats)
    torch_export.export_checkpoint(st_cfg, st_model.state_dict(), str(tmp_path / "st.pth"))
    want, got = (torch.load(p, weights_only=True) for p in (path, str(tmp_path / "st.pth")))
    assert list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want)


def test_best_checkpoint_file_layout(tmp_path):
    """model-best.pt is a weights-only torch.save of the trainable params
    and a None batch_stats, on the CPU."""
    model, state, _ = _fresh(Config(**SMALL), None)
    ckpt.save_best(str(tmp_path), state.params, None, {"iter": 1})
    blob = torch.load(tmp_path / "model-best.pt", weights_only=True)
    assert set(blob) == {"params", "batch_stats"} and blob["batch_stats"] is None
    assert set(blob["params"]) == set(ckpt.trainable_state_dict(model))
    assert not any(k.startswith("encoder.") for k in blob["params"])
    assert json.loads((tmp_path / "infos-best.json").read_text()) == {"iter": 1}
