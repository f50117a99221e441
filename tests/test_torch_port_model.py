"""PyTorch port, model and decoding against the JAX package on the CPU.

Weights come from the JAX model's random init and cross through
``ckpt.convert.from_jax_params``; inputs come from numpy. In fp32 the
decoded ids must be identical.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from show_and_tell_tpu.config import Config as JConfig
from show_and_tell_tpu.data import transforms as jtransforms
from show_and_tell_tpu.decode.beam import beam_search as jbeam
from show_and_tell_tpu.decode.dispatch import decode_ids as jdecode_ids
from show_and_tell_tpu.decode.greedy import greedy_decode as jgreedy
from show_and_tell_tpu.models.registry import build_model as jbuild
from show_and_tell_tpu.utils.vocab import END_ID
from show_and_tell_tpu_torch.ckpt.convert import from_jax_params
from show_and_tell_tpu_torch.config import Config
from show_and_tell_tpu_torch.data import transforms
from show_and_tell_tpu_torch.decode.beam import beam_search
from show_and_tell_tpu_torch.decode.dispatch import decode_ids
from show_and_tell_tpu_torch.decode.greedy import greedy_decode
from show_and_tell_tpu_torch.models.registry import build_model

V = 50
SMALL = dict(embed_size=16, hidden_size=24, crop_size=32, max_decode_len=8)


@functools.lru_cache(maxsize=None)
def _jax_init(seed):
    """The JAX model's random init at the SMALL widths, as numpy trees (it
    does not depend on the dtype or the decode settings)."""
    trainable, frozen = jbuild(JConfig(**SMALL), V).init(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, trainable), jax.tree.map(np.asarray, frozen)


def _pair(dtype="float32", end_bias=0.0, seed=0, **kw):
    """The JAX model and its trees, and the port's model with the same
    weights. ``end_bias`` raises the <end> logit so that rows finish early."""
    args = dict(SMALL, dtype=dtype, **kw)
    jcfg, cfg = JConfig(**args), Config(**args)
    jm = jbuild(jcfg, V)
    trainable, frozen = _jax_init(seed)
    trainable = jax.tree.map(np.copy, trainable)
    trainable["classifier"]["b"][END_ID] += end_bias
    tm = build_model(cfg, V, device="cpu")
    tm.load_state_dict(from_jax_params(trainable, frozen))
    return jcfg, jm, trainable, frozen, cfg, tm


def _feats(B, L=4, seed=0):
    f = np.random.default_rng(seed).random((B, L, 512), dtype=np.float32)
    return jnp.asarray(f), torch.from_numpy(f)


def test_eval_transform_matches_jax():
    imgs = np.random.default_rng(0).integers(0, 256, (2, 40, 44, 3), dtype=np.uint8)
    want = jtransforms.eval_transform(jnp.asarray(imgs), 32)
    got = transforms.eval_transform(torch.from_numpy(imgs), 32)
    assert got.shape == (2, 32, 32, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("crop", [32, 64])
def test_vgg16_trunk_matches_jax(crop):
    _, jm, _, frozen, _, tm = _pair()
    x = np.random.default_rng(crop).standard_normal((2, crop, crop, 3)).astype(np.float32)
    want = np.asarray(jm.backbone_features(frozen, jnp.asarray(x)))
    got = tm.backbone_features(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, (crop // 16) ** 2, 512)
    # conv sums run in another order: 1e-4 of the feature scale
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-4 * scale


def test_from_torch_vgg16_matches_jax():
    """A torchvision VGG16 state dict gives the same 12 convs, in the port's
    [out, in, kh, kw] layout where the JAX package has HWIO."""
    from show_and_tell_tpu.models.encoders import from_torch_vgg16 as jfrom
    from show_and_tell_tpu_torch.models.encoders import from_torch_vgg16

    rng = np.random.default_rng(0)
    sd = {}
    for n, i in enumerate((0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)):
        sd[f"features.{i}.weight"] = rng.standard_normal((n + 2, n + 1, 3, 3)).astype(np.float32)
        sd[f"features.{i}.bias"] = rng.standard_normal(n + 2).astype(np.float32)
    want = jfrom(sd)["convs"]
    got = from_torch_vgg16({k: torch.from_numpy(v) for k, v in sd.items()})["convs"]
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["w"].numpy(), np.asarray(w["w"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(g["b"].numpy(), np.asarray(w["b"]))


def _forced_steps(jm, trainable, tm, feats, k, steps=5, seed=0):
    """Step logits of both models over the same forced tokens."""
    jf, tf = feats
    B = jf.shape[0]
    jstep, jcarry, _ = jm.make_decode_state(trainable, jf, beam_size=k)
    tstep, tcarry, _ = tm.make_decode_state(tf, beam_size=k)
    toks = np.random.default_rng(seed).integers(0, V, (steps, B * k))
    for t in range(steps):
        jcarry, jl = jstep(jcarry, jnp.asarray(toks[t], jnp.int32))
        tcarry, tl = tstep(tcarry, torch.from_numpy(toks[t]))
        yield np.asarray(jl, np.float32), tl.float().numpy()


@pytest.mark.parametrize("k", [1, 3])
def test_decode_step_logits_match_jax(k):
    _, jm, trainable, _, _, tm = _pair()
    for jl, tl in _forced_steps(jm, trainable, tm, _feats(2), k):
        assert tl.shape == jl.shape == (2 * k, V)
        assert np.abs(tl - jl).max() <= 1e-5 * np.abs(jl).max()


@pytest.mark.parametrize("k", [1, 3])
def test_decode_step_logits_bf16_close_to_jax(k):
    """bf16 rounds at other places in the two frameworks, so ids may
    differ; the logits agree to 2e-2."""
    _, jm, trainable, _, _, tm = _pair(dtype="bfloat16")
    for jl, tl in _forced_steps(jm, trainable, tm, _feats(2), k):
        np.testing.assert_allclose(tl, jl, atol=2e-2, rtol=0)


def _decode_both(mode, early_stop, return_all=False):
    jcfg, jm, trainable, _, cfg, tm = _pair(end_bias=0.6, beam_size=3)
    jf, tf = _feats(3, seed=1)
    k = 3 if mode == "beam" else 1
    jstep, jcarry, _ = jm.make_decode_state(trainable, jf, beam_size=k)
    tstep, tcarry, _ = tm.make_decode_state(tf, beam_size=k)
    if mode == "greedy":
        want = jgreedy(jstep, jcarry, 3, 8, early_stop=early_stop)
        got = greedy_decode(tstep, tcarry, 3, 8, early_stop=early_stop)
        return np.asarray(want), got.numpy(), None
    want = jbeam(jstep, jcarry, 3, 3, 8, tile=False, return_all=return_all,
                 early_stop=early_stop)
    got = beam_search(tstep, tcarry, 3, 3, 8, tile=False, return_all=return_all,
                      early_stop=early_stop)
    return np.asarray(want[0]), got[0].numpy(), (np.asarray(want[1]), got[1].numpy())


@pytest.mark.parametrize("early_stop", [True, False], ids=["early", "full"])
@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_decode_ids_identical_to_jax_fp32(mode, early_stop):
    want, got, scores = _decode_both(mode, early_stop)
    np.testing.assert_array_equal(got, want)
    assert (want == END_ID).any(), "the <end> bias should finish some rows"
    if scores is not None:
        np.testing.assert_allclose(scores[1], scores[0], atol=1e-5, rtol=0)


def test_beam_return_all_nbest_identical_to_jax():
    want, got, scores = _decode_both("beam", True, return_all=True)
    assert got.shape == (3, 3, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(scores[1], scores[0], atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_decode_ids_dispatch_identical_to_jax(mode):
    jcfg, jm, trainable, _, cfg, tm = _pair(end_bias=0.6)
    jf, tf = _feats(3, seed=2)
    want = jdecode_ids(jm, jcfg, trainable, None, jf, mode)
    got = decode_ids(tm, cfg, tf, mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
