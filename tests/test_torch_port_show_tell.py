"""PyTorch port, Show-and-Tell against the JAX package on the CPU.

Weights come from a numpy seed, shaped by tracing the JAX init
(``jax.eval_shape``; running it would build a ResNet-152 with jax.random),
and cross to the port by ``ckpt.convert.from_jax_params``. The decoder runs
at E=16, H=24 (H=128 where the JAX cell runs its Pallas kernel in interpret
mode), features [B, 2048] stand in for the trunk, and the tests that need
images run the full-depth ResNet-152 on 32 px crops. Tolerances are stated
beside each test; ``tests/torch_port_parity.py`` prints the figures.
"""

import contextlib
import functools
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_encoders as tpe
from show_and_tell_tpu import ckpt as jckpt
from show_and_tell_tpu.ckpt import torch_export as jexport
from show_and_tell_tpu.cli import export_torch as jexport_cli
from show_and_tell_tpu.config import Config as JConfig
from show_and_tell_tpu.decode.beam import beam_search as jbeam
from show_and_tell_tpu.decode.dispatch import decode_ids as jdecode_ids
from show_and_tell_tpu.models.registry import build_model as jbuild
from show_and_tell_tpu.ops import lstm as jlstm
from show_and_tell_tpu.serve import Captioner as JCaptioner
from show_and_tell_tpu.train import step as jstep
from show_and_tell_tpu.utils.vocab import Vocabulary as JVocabulary
from show_and_tell_tpu_torch import ckpt
from show_and_tell_tpu_torch.ckpt import torch_export, torch_import
from show_and_tell_tpu_torch.ckpt.convert import from_jax_params, from_jax_trainable, to_jax_trainable
from show_and_tell_tpu_torch.cli import export_torch
from show_and_tell_tpu_torch.cli import main as cli_main
from show_and_tell_tpu_torch.config import Config
from show_and_tell_tpu_torch.decode.beam import beam_search
from show_and_tell_tpu_torch.decode.dispatch import decode_ids
from show_and_tell_tpu_torch.evalsuite.driver import make_trainer_eval_fn
from show_and_tell_tpu_torch.models import encoders
from show_and_tell_tpu_torch.models.registry import build_model
from show_and_tell_tpu_torch.serve import Captioner
from show_and_tell_tpu_torch.train.step import make_eval_loss_step, make_train_state, make_train_step
from show_and_tell_tpu_torch.utils.vocab import Vocabulary

WORDS = [f"w{i}" for i in range(26)]  # 30 ids with the four special tokens
V = len(WORDS) + 4
F = 2048  # the pooled ResNet-152 / Inception-v3 feature
SMALL = dict(model="show_tell", embed_size=16, hidden_size=24, crop_size=32, max_decode_len=6, beam_size=3)
B, T = 3, 7
LOGITS_ATOL = 1e-5  # fp32 decode_train logits against JAX
STEP_ATOL = 1e-5  # params and batch statistics after the train steps
LOSS_RTOL = 1e-5
NBEST_ATOL = 1e-5
# Adam divides each gradient element by its own magnitude, so an element
# whose gradient lies within ~1e3 roundings of zero (the projection's
# [2048, 16] gradient is a sum over the batch) moves by an amount set by the
# rounding: at lr 1e-3 one of the 32,768 moved 3.8e-5 apart in three steps.
# At lr 1e-4 such an element stays within 1e-5.
LR = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The file's small trunks and steps on one thread: under a parallel
    test run, more only spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset_pallas():
    yield
    jlstm.set_pallas_enabled(None)


def jax_weights(cfg_kw, seed=0, trunk=True):
    """The JAX model and its (trainable, frozen, batch_stats) filled from a
    numpy seed: every trainable leaf uniform in +-2 / sqrt(its first
    dimension) but the head's weight, in +-6 / sqrt(H) (captions that vary
    with the image), the BatchNorm scale in [0.5, 1.5], the ``<end>``
    logit's bias lowered by 3 (captions of a few words), running statistics
    around 0 and 1, and the trunk from ``tpe.fake_torchvision`` (None
    without ``trunk``: building one takes seconds)."""
    jm = jbuild(JConfig(**cfg_kw), V)
    rng = np.random.default_rng(seed)
    shapes = _shapes(tuple(sorted(cfg_kw.items())))

    def fill(leaf):
        bound = 2.0 / np.sqrt(leaf.shape[0])
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    trainable = jax.tree.map(fill, shapes)
    trainable["out"]["w"] *= 3.0
    trainable["bn"]["scale"] = rng.uniform(0.5, 1.5, cfg_kw["embed_size"]).astype(np.float32)
    trainable["out"]["b"][Vocabulary.from_words(WORDS)("<end>")] -= 3.0
    stats = {"mean": rng.normal(0, 0.1, cfg_kw["embed_size"]).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, cfg_kw["embed_size"]).astype(np.float32)}
    return jm, trainable, _jax_trunk(jm.encoder_name, seed) if trunk else None, stats


@functools.lru_cache(maxsize=None)
def _shapes(cfg_items):
    return jax.eval_shape(jbuild(JConfig(**dict(cfg_items)), V).init, jax.random.PRNGKey(0))[0]


@functools.lru_cache(maxsize=None)
def _jax_trunk(name, seed):
    return tpe.jax_trunk(name, tpe.fake_torchvision(name, seed))


def port_model(cfg, trainable, stats, frozen=None, trunk=True):
    """A port model holding the JAX trees; the trunk is ``frozen`` when it is
    given, else the port's own init, or none at all without ``trunk`` (for
    the tests that feed features: the trunk's random init of 60M weights
    would only cost time)."""
    if frozen is None and not trunk:
        with _no_trunk():
            m = build_model(cfg, V, device="cpu", generator=torch.Generator().manual_seed(0))
        assert not any(n.startswith("encoder.") for n in m.state_dict())
    else:
        m = build_model(cfg, V, device="cpu", generator=torch.Generator().manual_seed(0))
    if frozen is not None:
        m.load_state_dict(from_jax_params(trainable, frozen, stats))
    else:
        ckpt.copy_into(ckpt.trainable_state_dict(m), from_jax_trainable(trainable), "trainable")
        ckpt.copy_into(m.batch_stats, {k: torch.from_numpy(v) for k, v in stats.items()}, "stats")
    return m


@contextlib.contextmanager
def _no_trunk():
    """The port's ``init_encoder`` gives an empty trunk (the decoder's
    weights are drawn before the trunk's, so they stay as they are)."""
    real = encoders.init_encoder
    encoders.init_encoder = lambda name, generator=None, dtype=torch.float32: {}
    try:
        yield
    finally:
        encoders.init_encoder = real


def _pair(seed=0, trunk=False, **kw):
    """The JAX model, its trees and the port model over them. With
    ``trunk`` both hold a trunk (the JAX one from ``tpe.fake_torchvision``,
    the port's its own init); without, neither does: the tests that feed
    [B, 2048] features do not run one."""
    kw = dict(SMALL, **kw)
    jm, trainable, jfrozen, stats = jax_weights(kw, seed, trunk=trunk)
    cfg = Config(**kw)
    return jm, trainable, jfrozen, stats, cfg, port_model(cfg, trainable, stats, trunk=trunk)


def _batch(seed=0, nan=False):
    """(JAX batch, port batch): features [B, 2048], captions from <start>,
    lengths 7, 4 and 2."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, F)).astype(np.float32)
    if nan:
        feats[0, 0] = np.nan
    caps = np.concatenate([np.ones((B, 1), np.int32), rng.integers(4, V, (B, T - 1), dtype=np.int32)], 1)
    lens = np.array([T, 4, 2], np.int32)
    jb = {"features": jnp.asarray(feats), "captions": jnp.asarray(caps), "lengths": jnp.asarray(lens)}
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    return jb, tb


def _close(want, got, atol):
    np.testing.assert_allclose(
        np.asarray(got.detach().float().numpy() if torch.is_tensor(got) else got, np.float32),
        np.asarray(want, np.float32), atol=atol, rtol=0,
    )


def _trees_close(want, got_sd, atol):
    got = to_jax_trainable(got_sd)
    jax.tree.map(lambda w, g: _close(w, g, atol), jax.tree.map(np.asarray, want), got)


def _params_close(want, got_sd, steps):
    """Params after ``steps`` Adam steps within STEP_ATOL, but the
    projection's bias: the train-mode BatchNorm subtracts the batch mean,
    so its gradient is zero but for rounding, which Adam scales up to a
    step of up to ~lr on either side. It is held to 2 lr per step."""
    want = {k: np.asarray(v) for k, v in from_jax_trainable(want).items()}
    for k, w in want.items():
        _close(w, got_sd[k], 2 * LR * steps if k == "proj.b" else STEP_ATOL)


# --- the model --------------------------------------------------------------------


@pytest.mark.parametrize("encoder,name", [("vgg16", "resnet152"), ("resnet152", "resnet152"),
                                          ("inception_v3", "inception_v3")])
def test_model_layout_matches_jax(encoder, name):
    """The trunk by ``cfg.encoder`` (vgg16 maps to ResNet-152), the
    trainable names those of the JAX tree, the BatchNorm's statistics as
    buffers, and a frozen trunk."""
    jm, trainable, frozen, stats, cfg, m = _pair(encoder=encoder, num_layers=2, trunk=True)
    assert m.encoder_name == jm.encoder_name == name and m.feature_dim == jm.feature_dim == F
    assert set(ckpt.trainable_state_dict(m)) == set(from_jax_trainable(trainable))
    assert {n for n, _ in m.named_buffers()} == {"bn.mean", "bn.var"}
    assert m.batch_stats["mean"] is m.bn.mean
    enc = {n for n, p in m.named_parameters() if n.startswith("encoder.")}
    assert enc == {k for k in from_jax_params({}, frozen)} and not any(
        p.requires_grad for n, p in m.named_parameters() if n in enc)


@pytest.mark.parametrize("train", [True, False], ids=["train", "inference"])
def test_encode_matches_jax(train):
    """The projection (a 2048-long dot product) and the BatchNorm, and the
    new running statistics in train mode, within 1e-5 (fp32); the buffers
    are not written."""
    jm, trainable, _, stats, cfg, m = _pair()
    jb, tb = _batch(seed=1)
    jy, jstats = jm.encode(trainable, stats, jb["features"], train=train)
    before = {k: v.clone() for k, v in m.batch_stats.items()}
    ty, tstats = m.encode(tb["features"], train=train)
    _close(jy, ty, LOGITS_ATOL)
    for k in ("mean", "var"):
        _close(jstats[k], tstats[k], LOGITS_ATOL)
        assert torch.equal(m.batch_stats[k], before[k])


@pytest.mark.parametrize("ss", ["fast", "ss0"])
@pytest.mark.parametrize("num_layers", [1, 2])
def test_decode_train_matches_jax(num_layers, ss):
    """Teacher-forced logits within 1e-5: the fast path (head batched) and
    the scheduled-sampling path at ss_prob 0 (a tensor, not the Python
    0.0)."""
    jm, trainable, _, stats, cfg, m = _pair(num_layers=num_layers)
    jb, tb = _batch(seed=2)
    jfe, _ = jm.encode(trainable, stats, jb["features"], train=False)
    jss = 0.0 if ss == "fast" else jnp.asarray(0.0)
    want, jmask = jm.decode_train(trainable, jfe, jb["captions"], jb["lengths"], jax.random.PRNGKey(0), jss)
    tfe, _ = m.encode(tb["features"], train=False)
    tss = 0.0 if ss == "fast" else torch.tensor(0.0)
    got, mask = m.decode_train(tfe, tb["captions"], tb["lengths"], torch.Generator().manual_seed(0), tss)
    assert got.shape == (B, T - 1, V)
    _close(want, got, LOGITS_ATOL)
    assert np.array_equal(np.asarray(jmask), mask.numpy())


def test_decode_train_matches_jax_pallas_cell_interpret():
    """At H=128, the smallest H the JAX cell's tiler takes, the JAX stack
    runs its Pallas ``_cell_kernel`` in interpret mode (both layers)."""
    jm, trainable, _, stats, cfg, m = _pair(hidden_size=128, num_layers=2)
    jb, tb = _batch(seed=3)
    jlstm.set_pallas_enabled(True, interpret=True)
    assert jlstm._pick_tile(128, 16 + 128) and jlstm._pick_tile(128, 256)
    jfe, _ = jm.encode(trainable, stats, jb["features"], train=False)
    want, _ = jm.decode_train(trainable, jfe, jb["captions"], jb["lengths"])
    tfe, _ = m.encode(tb["features"], train=False)
    got, _ = m.decode_train(tfe, tb["captions"], tb["lengths"])
    _close(want, got, LOGITS_ATOL)


@pytest.mark.parametrize("mode", ["beam", "greedy"])
def test_decode_ids_identical_to_jax(mode):
    """fp32 ids from features [B, 2048] through ``decode_ids``: identical."""
    jm, trainable, _, stats, cfg, m = _pair(num_layers=2)
    feats = np.random.default_rng(4).standard_normal((5, F)).astype(np.float32)
    want = jdecode_ids(jm, JConfig(**dict(SMALL, num_layers=2)), trainable, stats, jnp.asarray(feats), mode)
    got = decode_ids(m, cfg, torch.from_numpy(feats), mode)
    assert np.array_equal(np.asarray(want), got.numpy())
    assert len({tuple(r) for r in got.tolist()}) > 1  # the captions vary with the image


def test_nbest_scores_match_jax():
    """Every beam's ids identical and its score within 1e-5."""
    jm, trainable, _, stats, cfg, m = _pair()
    feats = np.random.default_rng(5).standard_normal((4, F)).astype(np.float32)
    jstep_fn, jcarry, jfirst, jtile = jm.decode_state(trainable, stats, jnp.asarray(feats), 3)
    want_ids, want_scores = jbeam(jstep_fn, jcarry, 4, beam_size=3, max_len=6, first_logits=jfirst,
                                  tile=jtile, return_all=True)
    step_fn, carry, first, tile = m.decode_state(torch.from_numpy(feats), 3)
    ids, scores = beam_search(step_fn, carry, 4, beam_size=3, max_len=6, first_logits=first, tile=tile,
                              return_all=True)
    assert tile and np.array_equal(np.asarray(want_ids), ids.numpy())
    _close(want_scores, scores, NBEST_ATOL)


# --- training ---------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_train_step(cfg_items):
    """The JAX step of a configuration, compiled once per module: every test
    of that configuration reuses it."""
    jcfg = JConfig(**dict(cfg_items))
    return jstep.make_train_step(jbuild(jcfg, V), jcfg, donate=False)


def train_both(steps=3, nan_at=None, **kw):
    """The JAX step and the port's from the same weights over the same
    batches. Returns (JAX state, port state, [(JAX metrics, port metrics)])."""
    jm, trainable, _, stats, cfg, m = _pair(**kw)
    jcfg = JConfig(**dict(SMALL, **kw))
    jstate = jstep.make_train_state(jcfg, jax.tree.map(jnp.asarray, trainable), jax.tree.map(jnp.asarray, stats))
    jtrain = _jax_train_step(tuple(sorted(dict(SMALL, **kw).items())))
    state, train = make_train_state(cfg, m), make_train_step(m, cfg)
    metrics = []
    for i in range(steps):
        jb, tb = _batch(seed=10 + i, nan=(i == nan_at))
        jstate, jmet = jtrain(jstate, None, jb, LR, 0.0, jax.random.PRNGKey(i))
        state, met = train(state, tb, LR)
        metrics.append((jmet, met))
    return jstate, state, metrics, m


@pytest.mark.parametrize("kw", [{}, {"num_layers": 2, "grad_accum_steps": 2}], ids=["plain", "2layers-accum2"])
def test_train_steps_match_jax(kw):
    """Three steps: the loss within 1e-5 relative, the params
    (``_params_close``) and the running statistics within 1e-5, and the
    statistics are the model's own buffers, moved on every micro-step."""
    jstate, state, metrics, m = train_both(**kw)
    for jmet, met in metrics:
        assert float(met["loss"]) == pytest.approx(float(jmet["loss"]), rel=LOSS_RTOL, abs=0)
        assert float(met["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=LOSS_RTOL, abs=0)
    _params_close(jstate.params, state.params, 3)
    for k in ("mean", "var"):
        _close(jstate.batch_stats[k], state.batch_stats[k], STEP_ATOL)
        assert state.batch_stats[k] is m.batch_stats[k]
    start = jax_weights(SMALL, trunk=False)[3]["var"]
    assert not torch.equal(state.batch_stats["var"], torch.from_numpy(np.asarray(start)))


@pytest.mark.parametrize("skip", [True, False], ids=["skip", "apply"])
def test_nonfinite_step_and_batch_stats_match_jax(skip):
    """A NaN feature in the second of three batches. Under skip_nonfinite
    that step leaves the running statistics bit for bit as they were, on
    both sides (and the params); without it they take the NaN, as JAX's
    do."""
    jm, trainable, _, stats, cfg, m = _pair(skip_nonfinite=skip)
    jcfg = JConfig(**dict(SMALL, skip_nonfinite=skip))
    jstate = jstep.make_train_state(jcfg, jax.tree.map(jnp.asarray, trainable), jax.tree.map(jnp.asarray, stats))
    jtrain = _jax_train_step(tuple(sorted(dict(SMALL, skip_nonfinite=skip).items())))
    state, train = make_train_state(cfg, m), make_train_step(m, cfg)
    for i in range(2):
        jb, tb = _batch(seed=20 + i, nan=(i == 1))
        jbefore = jax.tree.map(np.array, jstate.batch_stats)
        before = {k: v.clone() for k, v in state.batch_stats.items()}
        pbefore = {k: v.clone() for k, v in state.params.items()}
        jstate, _ = jtrain(jstate, None, jb, LR, 0.0, jax.random.PRNGKey(i))
        state, _ = train(state, tb, LR)
    for k in ("mean", "var"):
        if skip:
            assert np.array_equal(np.asarray(jstate.batch_stats[k]), jbefore[k])
            assert torch.equal(state.batch_stats[k], before[k])
        else:
            assert np.isnan(np.asarray(jstate.batch_stats[k])).all() and torch.isnan(state.batch_stats[k]).all()
    if skip:
        assert all(torch.equal(state.params[k], pbefore[k]) for k in pbefore)
        _params_close(jstate.params, state.params, 1)


def test_eval_loss_matches_jax():
    """The eval loss normalises with the running statistics."""
    jm, trainable, frozen, stats, cfg, m = _pair()
    jb, tb = _batch(seed=6)
    want = jstep.make_eval_loss_step(jm, JConfig(**SMALL))(trainable, stats, frozen, jb)
    got = make_eval_loss_step(m, cfg)(tb)
    assert float(got[0]) == pytest.approx(float(want[0]), rel=LOSS_RTOL, abs=0)
    assert float(got[1]) == float(want[1])


def test_trainer_eval_swap_leaves_the_batch_stats():
    """The gate's weight swap (an EMA's params) touches no BatchNorm
    buffer: evaluation runs on the running statistics."""
    _, trainable, _, stats, cfg, m = _pair()
    seen = []
    batch = {k: v.numpy() for k, v in _batch(seed=7)[1].items()}
    batch.update(imgids=list(range(B)), cocoids=list(range(B)))
    fn = make_trainer_eval_fn(m, cfg.replace(language_eval=0), [batch], Vocabulary.from_words(WORDS))
    own = {k: v.clone() for k, v in m.batch_stats.items()}
    other = {k: v + 0.1 for k, v in ckpt.trainable_state_dict(m).items()}
    import show_and_tell_tpu_torch.evalsuite.driver as driver

    real = driver.evaluation

    def spy(model, *a, **k):
        seen.append({n: v.clone() for n, v in model.batch_stats.items()})
        return real(model, *a, **k)

    driver.evaluation = spy
    try:
        fn(other)
    finally:
        driver.evaluation = real
    assert all(torch.equal(seen[0][k], own[k]) and torch.equal(m.batch_stats[k], own[k]) for k in own)


# --- checkpoints --------------------------------------------------------------------


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """JAX and port Captioners over one set of weights with the trunk: the
    JAX one built on the trees, the port one by ``from_checkpoint`` from a
    JAX ``model-best.msgpack`` and a torchvision ResNet-152 file. The
    running statistics are those of the projected features of the test
    images, so that the BatchNorm's output and the captions vary."""
    d = tmp_path_factory.mktemp("show_tell")
    jm, trainable, frozen, _ = jax_weights(dict(SMALL, dtype="float32"))
    cfg = Config(**SMALL, dtype="float32")
    images = np.random.default_rng(8).integers(0, 256, (5, 256, 256, 3), dtype=np.uint8)
    m = port_model(cfg, trainable, {"mean": np.zeros(16, np.float32), "var": np.ones(16, np.float32)}, frozen)
    from show_and_tell_tpu_torch.data.transforms import eval_transform

    with torch.no_grad():
        f = m.encode(m.backbone_features(eval_transform(torch.from_numpy(images), 32)), train=False)[0]
    scale = trainable["bn"]["scale"]
    stats = {"mean": ((f.mean(0).numpy() - trainable["bn"]["bias"]) / scale).astype(np.float32),
             "var": ((f.var(0).numpy() + 1e-5) / scale ** 2).astype(np.float32)}
    jckpt.save_best(str(d / "exp"), trainable, stats, {"iter": 1})
    enc = str(d / "resnet152.pth")
    jsd = from_jax_params({}, frozen)
    torch.save(encoders.to_torch_resnet152(encoders.module_tree(_trunk_module(jsd))), enc)
    jcap = JCaptioner(JConfig(**SMALL), jm, trainable, frozen, JVocabulary.from_words(WORDS), stats, bucket_sizes=(4,))
    tcap = Captioner.from_checkpoint(cfg.replace(encoder_weights=enc), str(d / "exp"), Vocabulary.from_words(WORDS),
                                     device="cpu", bucket_sizes=(4,))
    return {"dir": d, "jcap": jcap, "tcap": tcap, "images": images, "trainable": trainable, "frozen": frozen,
            "stats": stats, "enc": enc, "jm": jm}


def _trunk_module(sd):
    module = encoders.frozen_module(encoders.init_encoder("resnet152"))
    module.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()})
    return module


@pytest.mark.parametrize("mode", ["beam", "greedy"])
def test_captioner_matches_jax(served, mode):
    """Captions from uint8 images through the ResNet-152 trunk, the port's
    Captioner restored from the JAX experiment: identical in fp32."""
    want = served["jcap"].caption_images(served["images"], mode=mode)
    got = served["tcap"].caption_images(served["images"], mode=mode)
    assert got == want and len(set(got)) > 1


def test_jax_checkpoints_read_by_port(served, tmp_path):
    """``model-best.msgpack`` gives equal params and statistics; a JAX
    ``state-last.msgpack`` after two steps gives equal params, moments,
    statistics, count and step."""
    cap = served["tcap"]
    want = from_jax_params(served["trainable"], served["frozen"], served["stats"])
    sd = cap.model.state_dict()
    assert all(torch.equal(sd[k], want[k]) for k in want) and set(sd) == set(want)
    jstate, state, _, _ = train_both(steps=2)
    jckpt.save_train_state(str(tmp_path), jax.device_get(jstate))
    _, _, _, _, cfg, m = _pair(seed=1)
    got = ckpt.load_train_state(str(tmp_path), make_train_state(cfg, m))
    _trees_close(jstate.params, got.params, 0)
    _trees_close(jstate.opt_state[1].mu, got.opt_state["mu"], 0)
    for k in ("mean", "var"):
        _close(jstate.batch_stats[k], got.batch_stats[k], 0)
        assert got.batch_stats[k] is m.batch_stats[k]
    assert got.step == int(jstate.step) == 2 and got.opt_state["count"] == 2


def test_port_checkpoints_round_trip(served, tmp_path):
    """The port's ``model-best.pt`` and ``state-last.pt`` carry the
    statistics: a Captioner from them captions as the one they came from,
    and a resumed step equals a straight one, bit for bit."""
    cap = served["tcap"]
    ckpt.save_best(str(tmp_path / "best"), ckpt.trainable_state_dict(cap.model), cap.model.batch_stats, {})
    blob = torch.load(tmp_path / "best" / "model-best.pt", weights_only=True)
    assert set(blob["batch_stats"]) == {"mean", "var"}
    back = Captioner.from_checkpoint(cap.cfg, str(tmp_path / "best"), Vocabulary.from_words(WORDS),
                                     device="cpu", bucket_sizes=(4,))
    for mode in ("beam", "greedy"):
        assert back.caption_images(served["images"], mode) == cap.caption_images(served["images"], mode)
    _, state, _, m = train_both(steps=2)
    ckpt.save_train_state(str(tmp_path / "st"), state)
    _, _, _, _, cfg, m2 = _pair(seed=1)
    state2 = ckpt.load_train_state(str(tmp_path / "st"), make_train_state(cfg, m2))
    jb, tb = _batch(seed=40)
    for s, mod in ((state, m), (state2, m2)):
        make_train_step(mod, cfg)(s, tb, LR)
    assert all(torch.equal(state.params[k], state2.params[k]) for k in state.params)
    assert all(torch.equal(state.batch_stats[k], state2.batch_stats[k]) for k in ("mean", "var"))
    # a model with statistics refuses a file without them
    ckpt.save_best(str(tmp_path / "nostats"), ckpt.trainable_state_dict(m2), None, {})
    with pytest.raises(ValueError, match="holds no batch_stats"):
        ckpt.load_best_params(str(tmp_path / "nostats"), ckpt.trainable_state_dict(m2), m2.batch_stats)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_export_matches_jax_key_for_key(num_layers, tmp_path):
    """The port's export of a state dict equals the JAX ``export_show_tell``
    key for key (order, dtype, values), and imports back bit for bit."""
    jm, trainable, frozen, stats, cfg, m = _pair(num_layers=num_layers)
    want = jexport.export_show_tell(trainable, stats, num_layers=num_layers)
    got = torch_export.export_show_tell(m.state_dict(), num_layers)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert [list(d) for d in torch_export.split_show_tell(got)] == [list(d) for d in jexport.split_show_tell(want)]
    back, bstats, trunk = torch_import.import_show_tell(got, num_layers)
    assert trunk is None and set(back) == set(ckpt.trainable_state_dict(m))
    assert all(torch.equal(v, m.state_dict()[k]) for k, v in back.items())
    assert all(torch.equal(bstats[k], m.batch_stats[k]) for k in bstats)
    torch_export.export_checkpoint(cfg, m.state_dict(), str(tmp_path / "st.pth"))
    jexport.save_state_dict(want, str(tmp_path / "jax.pth"))
    loaded, jloaded = (torch.load(tmp_path / f, weights_only=True) for f in ("st.pth", "jax.pth"))
    assert list(loaded) == list(jloaded) and all(torch.equal(loaded[k], jloaded[k]) for k in jloaded)


def test_reference_pth_imports_and_serves_as_jax(served, tmp_path):
    """The JAX ``export_show_tell`` file, read by ``load_reference_checkpoint``:
    the params and statistics the JAX importer gives; served through
    ``cfg.torch_checkpoint`` (with a ``module.`` prefix, and the trunk from
    ``encoder_weights``) it captions as the JAX Captioner."""
    from show_and_tell_tpu.ckpt import torch_import as jimport

    sd = jexport.export_show_tell(served["trainable"], served["stats"])
    path = str(tmp_path / "model-best.pth")
    torch.save({f"module.{k}": torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)
    jt, jstats, jfr = jimport.load_reference_checkpoint(path, "show_tell", 1)
    t, stats, trunk = torch_import.load_reference_checkpoint(path, "show_tell", 1)
    assert trunk is None and jfr is None
    want = from_jax_trainable(jt)
    assert set(t) == set(want) and all(torch.equal(t[k], want[k]) for k in want)
    assert all(np.array_equal(stats[k].numpy(), np.asarray(jstats[k])) for k in ("mean", "var"))
    cfg = served["tcap"].cfg.replace(torch_checkpoint=path, encoder_weights=served["enc"])
    cap = Captioner.from_checkpoint(cfg, None, Vocabulary.from_words(WORDS), device="cpu", bucket_sizes=(4,))
    for mode in ("beam", "greedy"):
        assert cap.caption_images(served["images"], mode) == served["jcap"].caption_images(served["images"], mode)


def test_caption_with_attention_raises_as_jax_and_warmup_skips_it(served):
    """No attention maps: the JAX ``ValueError``. The port's warmup skips
    "attention" for such a model, where the JAX warmup raises (a difference
    on purpose, ROADMAP.md C)."""
    for cap in (served["jcap"], served["tcap"]):
        with pytest.raises(ValueError, match="exposes no attention maps"):
            cap.caption_with_attention(served["images"][:1])
    with pytest.raises(ValueError, match="exposes no attention maps"):
        served["jcap"].warmup(modes=("attention",), buckets=(4,))
    assert served["tcap"].warmup(modes=("attention", "greedy"), buckets=(4,)) >= 0


# --- the CLIs -----------------------------------------------------------------------


def test_cli_export_torch_matches_jax_cli(served, tmp_path, monkeypatch):
    """Both export CLIs over the JAX experiment: the same ``.pth``. (Neither
    CLI's random trunk, which a Show-and-Tell export leaves out, is built:
    running the JAX init of a ResNet-152 takes ~9 s here.)"""
    from show_and_tell_tpu.models import encoders as jenc

    monkeypatch.setattr(jenc, "init_encoder", lambda name, key, dtype=None: {})
    monkeypatch.setattr(encoders, "init_encoder", lambda name, generator=None, dtype=torch.float32: {})
    vocab = str(tmp_path / "vocab.json")
    Vocabulary.from_words(WORDS).save(vocab)
    argv = ["--model", "show_tell", "--embed_size", "16", "--hidden_size", "24", "--vocab_path", vocab,
            "--load_model_path", str(served["dir"] / "exp")]
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        jexport_cli.main(argv + ["--export_path", str(tmp_path / "jax.pth")])
        export_torch.main(argv + ["--export_path", str(tmp_path / "torch.pth")], device="cpu")
    finally:
        os.chdir(cwd)
    want, got = (torch.load(tmp_path / f"{p}.pth", weights_only=True) for p in ("jax", "torch"))
    assert list(got) == list(want)
    assert all(got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]) for k in want)


def test_cli_main_trains_show_tell(tmp_path):
    """``cli.main --model show_tell`` on an ``.npz`` of [2048] features: it
    trains, gates, and writes model-best.pt with the running statistics of
    the trained model."""
    from test_torch_port_data import run_preprocess, write_corpus

    root = str(tmp_path)
    caption_json, images_root = write_corpus(root, n_train=8, n_val=4, sents=1, img_hw=(40, 44))
    vocab_path, data_json = run_preprocess("torch", os.path.join(root, "pre"), caption_json, images_root,
                                           resize=False)
    rng = np.random.default_rng(9)
    ids = sorted({r["cocoid"] for r in json.load(open(data_json))})
    npz = os.path.join(root, "feats.npz")
    np.savez(npz, **{str(c): rng.standard_normal(F).astype(np.float32) for c in ids})
    cfg = Config(**dict(SMALL, batch_size=4, max_epochs=2, save_checkpoint_every=2, num_devices=1,
                        data_json=data_json, vocab_path=vocab_path, features_path=npz, language_eval=0,
                        expr_dir=os.path.join(root, "exp")))
    cwd = os.getcwd()
    os.chdir(root)
    try:
        tr = cli_main.main(cfg, device="cpu")
    finally:
        os.chdir(cwd)
    assert tr.state.step >= 2 and tr.state.batch_stats["mean"] is tr.model.bn.mean
    assert not torch.equal(tr.model.bn.var, torch.ones(16))
    blob = torch.load(os.path.join(tr.cfg.expr_dir, "model-best.pt"), weights_only=True)
    assert set(blob["batch_stats"]) == {"mean", "var"}
    state = torch.load(os.path.join(tr.cfg.expr_dir, "state-last.pt"), weights_only=True)
    assert all(torch.equal(state["batch_stats"][k], tr.model.batch_stats[k]) for k in ("mean", "var"))


def test_http_and_caption_cli_answer_as_jax(served, tmp_path, monkeypatch):
    """Over HTTP, ``/caption`` gives the JAX server's JSON and
    ``?attention=1`` its 400; ``cli.caption --attention_dir`` stops with the
    JAX CLI's message before any caption."""
    from PIL import Image

    from show_and_tell_tpu.cli import caption as jcaption
    from show_and_tell_tpu.models import encoders as jenc
    from show_and_tell_tpu_torch.cli import caption
    from test_torch_port_http import request, serving

    buf = io.BytesIO()
    Image.fromarray(served["images"][0]).save(buf, format="PNG")
    png = buf.getvalue()
    answers = {}
    for pkg, cap in (("jax", served["jcap"]), ("torch", served["tcap"])):
        with serving(pkg, cap) as (url, _):
            answers[pkg] = [request(url + path, png) for path in
                            ("/caption?mode=greedy", "/caption?mode=beam", "/caption?attention=1")]
    assert answers["torch"] == answers["jax"]
    assert answers["torch"][2][0] == 400 and "exposes no attention maps" in answers["torch"][2][1]["error"]
    monkeypatch.setattr(jenc, "init_encoder", lambda name, key, dtype=None: {})
    vocab = str(tmp_path / "vocab.json")
    Vocabulary.from_words(WORDS).save(vocab)
    Image.fromarray(served["images"][0]).save(tmp_path / "a.png")
    argv = ["--model", "show_tell", "--embed_size", "16", "--hidden_size", "24", "--crop_size", "32",
            "--vocab_path", vocab, "--load_model_path", str(served["dir"] / "exp"),
            "--encoder_weights", served["enc"], "--attention_dir", str(tmp_path / "sheets"), str(tmp_path / "a.png")]
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as jerr:
        jcaption.main(argv)
    with pytest.raises(SystemExit) as terr:
        caption.main(argv, device="cpu")
    assert str(terr.value) == str(jerr.value) and "exposes no attention maps" in str(terr.value)
