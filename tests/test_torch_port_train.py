"""PyTorch port, the training slice against the JAX package on the CPU.

Weights come from the JAX model's random init and cross through
``ckpt.convert.from_jax_params``; inputs come from numpy. The port's
parameters and Adam moments go back through ``to_jax_params``
(``tests/torch_port_parity.py``) to be compared with the JAX trees. The two
frameworks draw different random numbers from a seed, so the comparisons
use the deterministic paths (no dropout; scheduled sampling at probability
0 or 1) and the random crop is checked on its properties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_model as tpm
from torch_port_parity import to_jax_params
from show_and_tell_tpu.data import transforms as jtransforms
from show_and_tell_tpu.train import losses as jlosses
from show_and_tell_tpu.train import step as jstep
from show_and_tell_tpu_torch.data import transforms
from show_and_tell_tpu_torch.models.layers import dropout
from show_and_tell_tpu_torch.train import losses
from show_and_tell_tpu_torch.train.step import (
    make_eval_loss_step,
    make_train_state,
    make_train_step,
)

B, T, L = 3, 7, 4
# the Config default. Adam turns a gradient near its eps (1e-8), where the
# two frameworks' last digits differ, into a step of a sizeable fraction of
# lr, so the params after a step differ by up to ~1e-2 * lr (8.5e-6 at 3
# steps here) while the gradients agree to ~1e-6 of their scale
LR = 1e-3


def _batch(seed=0, nan=False):
    """(JAX batch, port batch): features [B, L, 512], captions from <start>,
    lengths 7, 4 and 2 (the last row scores one token)."""
    rng = np.random.default_rng(seed)
    feats = rng.random((B, L, 512), dtype=np.float32)
    if nan:
        feats[0, 0, 0] = np.nan
    caps = np.concatenate([np.ones((B, 1), np.int32), rng.integers(4, tpm.V, (B, T - 1), dtype=np.int32)], 1)
    lens = np.array([T, 4, 2], np.int32)
    jb = {"features": jnp.asarray(feats), "captions": jnp.asarray(caps), "lengths": jnp.asarray(lens)}
    tb = {"features": torch.from_numpy(feats), "captions": torch.from_numpy(caps), "lengths": torch.from_numpy(lens)}
    return jb, tb


def _close(want, got, atol):
    np.testing.assert_allclose(
        np.asarray(got.detach().float().numpy() if torch.is_tensor(got) else got, np.float32),
        np.asarray(want, np.float32), atol=atol, rtol=0,
    )


def _trees_close(want, got, atol):
    jax.tree.map(lambda w, g: _close(w, g, atol), want, got)


def test_trainable_parameters_require_grad_and_the_trunk_does_not():
    _, _, trainable, _, _, tmod = tpm._pair()
    names = {n for n, p in tmod.named_parameters() if p.requires_grad}
    assert len(names) == len(jax.tree.leaves(trainable))
    assert {n.split(".")[0] for n in names} == set(trainable)
    assert not any(p.requires_grad for p in tmod.encoder.parameters())


def test_decode_train_fast_path_matches_jax():
    _, jm, trainable, _, _, tmod = tpm._pair()
    jb, tb = _batch()
    want = jm.decode_train(trainable, jb["features"], jb["captions"], jb["lengths"])
    got = tmod.decode_train(tb["features"], tb["captions"], tb["lengths"])
    assert got[0].shape == (B, T - 1, tpm.V) and got[2].shape == (B, T - 1, L)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    _close(want[0], got[0], 1e-5)
    _close(want[2], got[2], 1e-5)


@pytest.mark.parametrize("ss", [0.0, 1.0])
def test_decode_train_general_path_matches_jax(ss):
    """The per-step path, entered with ss_prob as an array (JAX) or a tensor
    (the port). At 0 and at 1 it draws nothing that matters: every row takes
    the caption's token, or from step 1 on its own previous argmax."""
    _, jm, trainable, _, _, tmod = tpm._pair()
    jb, tb = _batch(seed=1)
    want = jm.decode_train(trainable, jb["features"], jb["captions"], jb["lengths"],
                           ss_prob=jnp.asarray(ss, jnp.float32))
    got = tmod.decode_train(tb["features"], tb["captions"], tb["lengths"],
                            ss_prob=torch.tensor(ss))
    _close(want[0], got[0], 1e-5)
    _close(want[2], got[2], 1e-5)


def test_decode_train_fast_path_equals_general_path():
    _, _, _, _, _, tmod = tpm._pair()
    _, tb = _batch(seed=2)
    args = (tb["features"], tb["captions"], tb["lengths"])
    fast = tmod.decode_train(*args)
    general = tmod.decode_train(*args, ss_prob=torch.tensor(0.0))
    for a, b in zip(fast, general):
        _close(a.detach().numpy(), b, 1e-5)


def test_greedy_with_attention_matches_jax():
    _, jm, trainable, _, _, tmod = tpm._pair()
    jb, tb = _batch(seed=3)
    want_ids, want_alphas = jm.greedy_with_attention(trainable, jb["features"], max_len=6)
    ids, alphas = tmod.greedy_with_attention(tb["features"], max_len=6)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    _close(want_alphas, alphas, 1e-5)


def test_masked_cross_entropy_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((B, T - 1, tpm.V)).astype(np.float32) * 3
    targets = rng.integers(0, tpm.V, (B, T - 1))
    mask = np.arange(T - 1)[None, :] < np.array([[6], [3], [0]])
    for lg in (logits, logits.astype(jnp.bfloat16)):
        want = jlosses.masked_cross_entropy(jnp.asarray(lg), jnp.asarray(targets), jnp.asarray(mask))
        got = losses.masked_cross_entropy(
            torch.from_numpy(np.asarray(lg, np.float32)).to(torch.bfloat16 if lg.dtype != np.float32 else torch.float32),
            torch.from_numpy(targets), torch.from_numpy(mask),
        )
        _close(want[0], got[0], 1e-5)
        assert float(got[1]) == float(want[1]) == 9.0
    # no valid token: the count is held at 1 and the loss is 0
    none = losses.masked_cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets),
                                       torch.zeros(B, T - 1, dtype=torch.bool))
    assert float(none[0]) == 0.0 and float(none[1]) == 1.0


CASES = {
    "plain": {},
    "accum2": {"grad_accum_steps": 2},
    "ema": {"ema_decay": 0.9},
    "nan_skip": {},
}


def _adam_state(opt_state):
    """The Adam state inside the JAX optimizer chain (inside MultiSteps
    under accumulation)."""
    return getattr(opt_state, "inner_opt_state", opt_state)[1]


def train_both(case, steps=3):
    """The JAX step and the port's step from the same init over the same
    batches (the middle one with a NaN for "nan_skip"). Returns (JAX state,
    port state, [(JAX metrics, port metrics)] per step)."""
    jcfg, jm, trainable, frozen, cfg, tmod = tpm._pair(**CASES[case])
    batches = [_batch(seed=10 + i, nan=(case == "nan_skip" and i == 1)) for i in range(steps)]
    jstate = jstep.make_train_state(jcfg, jax.tree.map(jnp.asarray, trainable))
    jtrain = jstep.make_train_step(jm, jcfg, donate=False)
    state = make_train_state(cfg, tmod)
    train = make_train_step(tmod, cfg)
    metrics = []
    for i, (jb, tb) in enumerate(batches):
        jstate, jmet = jtrain(jstate, frozen, jb, LR, 0.0, jax.random.PRNGKey(i))
        state, met = train(state, tb, LR)
        metrics.append((jmet, met))
    return jstate, state, metrics


@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_match_jax(case):
    """Params and Adam moments after 3 steps from the same init: the plain
    step; 2-step accumulation (one update applied, one micro-batch pending);
    an EMA; and a NaN batch in the middle under skip_nonfinite."""
    jstate, state, metrics = train_both(case)
    for jmet, met in metrics:
        for k in ("loss", "grad_norm", "tokens"):
            _close(jmet[k], met[k], 1e-5)
    assert state.step == 3
    _trees_close(jstate.params, to_jax_params(state.params)[0], 1e-5)
    adam = _adam_state(jstate.opt_state)
    assert state.opt_state["count"] == int(adam.count) == {"accum2": 1, "nan_skip": 2}.get(case, 3)
    _trees_close(adam.mu, to_jax_params(state.opt_state["mu"])[0], 1e-5)
    _trees_close(adam.nu, to_jax_params(state.opt_state["nu"])[0], 1e-5)
    if case == "accum2":
        assert state.opt_state["mini_step"] == int(jstate.opt_state.mini_step) == 1
        _trees_close(jstate.opt_state.acc_grads, to_jax_params(state.opt_state["acc_grads"])[0], 1e-5)
    if case == "ema":
        _trees_close(jstate.ema_params, to_jax_params(state.ema_params)[0], 1e-5)
    else:
        assert state.ema_params is None


def test_eval_loss_matches_jax():
    jcfg, jm, trainable, frozen, cfg, tmod = tpm._pair()
    jb, tb = _batch(seed=5)
    want = jstep.make_eval_loss_step(jm, jcfg)(trainable, None, frozen, jb)
    got = make_eval_loss_step(tmod, cfg)(tb)
    _close(want[0], got[0], 1e-5)
    assert float(got[1]) == float(want[1])


def test_random_crop_flip_is_a_crop_of_its_input_flipped_or_not():
    imgs = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (16, 12, 10, 3), dtype=np.uint8))
    crop = 6
    out = transforms.random_crop_flip(torch.Generator().manual_seed(0), imgs, crop)
    assert out.shape == (16, crop, crop, 3) and out.dtype == torch.uint8
    seen = set()
    for i in range(16):
        found = [
            (top, left, flip)
            for top in range(12 - crop + 1)
            for left in range(10 - crop + 1)
            for flip in (False, True)
            if torch.equal(out[i], imgs[i, top:top + crop, left:left + crop].flip(1) if flip
                           else imgs[i, top:top + crop, left:left + crop])
        ]
        assert found, f"image {i} is not a crop of its input"
        seen.update(found)
    assert {f for _, _, f in seen} == {False, True}
    assert len({(t, l) for t, l, _ in seen}) > 4
    # the same generator state gives the same crops, and train_transform
    # normalises them as the eval side does
    again = transforms.train_transform(torch.Generator().manual_seed(0), imgs, crop)
    torch.testing.assert_close(again, transforms.normalize(out), rtol=0, atol=0)


@pytest.mark.parametrize("hw,size", [((10, 14), 16), ((40, 36), 16)], ids=["up", "down"])
def test_resize_matches_jax(hw, size):
    imgs = np.random.default_rng(7).integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    want = jtransforms.resize_bilinear(jnp.asarray(imgs), size)
    got = transforms.resize_bilinear(torch.from_numpy(imgs), size)
    assert got.shape == (2, size, size, 3) and got.dtype == torch.float32
    _close(want, got, 1e-3)  # values 0..255: fp32 sums in another order
    want = jtransforms.resize_transform(jnp.asarray(imgs), size, 12)
    got = transforms.resize_transform(torch.from_numpy(imgs), size, 12)
    _close(want, got, 1e-5)


def test_dropout_is_inverted_and_off_without_a_generator():
    x = torch.ones(4000)
    assert dropout(None, x, 0.5) is x
    assert dropout(torch.Generator().manual_seed(0), x, 0.0) is x
    y = dropout(torch.Generator().manual_seed(0), x, 0.25)
    kept = y != 0
    assert torch.all(y[kept] == 1 / 0.75)
    assert abs(kept.float().mean().item() - 0.75) < 0.03
