"""PyTorch port, Show-and-Tell's layers and trunks against the JAX package.

The BatchNorm layers and the pools at small shapes, and the full-depth
ResNet-152 (64 px) and Inception-v3 (139 px) at batch 1 in fp32, fed the
same numpy-seeded weights: a torchvision-named state dict goes through the
JAX package's ``from_torch_*`` converters, and the JAX trees cross to the
port by ``ckpt.convert.from_jax_params``. The port's own ``from_torch_*``
and ``to_torch_*`` are held against the JAX converters on the same dict.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from show_and_tell_tpu.models import encoders as jenc
from show_and_tell_tpu.models import layers as jlayers
from show_and_tell_tpu_torch.ckpt import convert
from show_and_tell_tpu_torch.ckpt.torch_import import encoder_state_dict
from show_and_tell_tpu_torch.models import encoders as tenc
from show_and_tell_tpu_torch.models import layers as tlayers

BN_ATOL = 1e-6  # fp32 BatchNorm outputs and running statistics
TRUNK_RTOL = 1e-4  # pooled trunk feature, max |diff| / max |JAX feature|
SIZES = {"resnet152": 64, "inception_v3": 139}


def _bn_params(rng, c):
    return {
        "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
        "bias": rng.normal(0, 0.5, c).astype(np.float32),
        "mean": rng.normal(0, 0.5, c).astype(np.float32),
        "var": rng.uniform(0.5, 2.0, c).astype(np.float32),
    }


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def test_batch_norm_inference_matches_jax():
    rng = np.random.default_rng(0)
    p = _bn_params(rng, 16)
    x = rng.normal(0, 2, (5, 3, 16)).astype(np.float32)
    want = jlayers.batch_norm_inference(_j(p), jnp.asarray(x))
    got = tlayers.batch_norm_inference(_t(p), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BN_ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(32, 16), (4, 3, 16)], ids=["2d", "3d"])
def test_batch_norm_train_matches_jax(shape):
    """y, and both running statistics after one update (momentum 0.01, the
    unbiased variance), within 1e-6 in fp32; the inputs are not written."""
    rng = np.random.default_rng(1)
    p = _bn_params(rng, shape[-1])
    x = rng.normal(1, 3, shape).astype(np.float32)
    jy, jnew = jlayers.batch_norm_train(_j(p), jnp.asarray(x), momentum=0.01)
    tp = _t(p)
    before = {k: v.clone() for k, v in tp.items()}
    ty, tnew = tlayers.batch_norm_train(tp, torch.from_numpy(x), momentum=0.01)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=BN_ATOL, rtol=0)
    for k in ("mean", "var"):
        np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]), atol=BN_ATOL, rtol=0)
    assert all(torch.equal(tp[k], before[k]) for k in tp)
    # bf16 input: statistics in fp32, y back in bf16
    yb, nb = tlayers.batch_norm_train(tp, torch.from_numpy(x).bfloat16())
    assert yb.dtype == torch.bfloat16 and nb["mean"].dtype == torch.float32


@pytest.mark.parametrize("padding,count_include_pad", [(0, True), (1, True), (1, False)],
                         ids=["valid", "pad-include", "pad-exclude"])
def test_avg_pool_matches_jax(padding, count_include_pad):
    x = np.random.default_rng(2).normal(0, 1, (2, 7, 9, 5)).astype(np.float32)
    jpad = "VALID" if padding == 0 else [(0, 0), (1, 1), (1, 1), (0, 0)]
    want = jlayers.avg_pool(jnp.asarray(x), 3, 1, jpad, count_include_pad=count_include_pad)
    got = tlayers.avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 1, padding, count_include_pad)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_global_avg_pool_matches_jax():
    x = np.random.default_rng(3).normal(0, 1, (2, 5, 6, 7)).astype(np.float32)
    want = jlayers.global_avg_pool(jnp.asarray(x))
    got = tlayers.global_avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


# --- the trunks -----------------------------------------------------------------


def fake_torchvision(name: str, seed: int = 0):
    """A torchvision-named state dict of trunk ``name`` as numpy: He-normal
    convs, BatchNorm scales in [0.2, 0.6] (so that 50 residual blocks keep
    their activations in range), random shifts and positive variances."""
    rng = np.random.default_rng(seed)
    tree = tenc.init_encoder(name, torch.Generator().manual_seed(seed))
    sd = (tenc.to_torch_resnet152 if name == "resnet152" else tenc.to_torch_inception_v3)(tree)
    out = {}
    for k, v in sd.items():
        if v.dim() == 4:
            fan_in = int(np.prod(v.shape[1:]))
            out[k] = rng.normal(0, np.sqrt(2.0 / fan_in), tuple(v.shape)).astype(np.float32)
        elif k.endswith("running_var"):
            out[k] = rng.uniform(0.5, 2.0, tuple(v.shape)).astype(np.float32)
        elif k.endswith("running_mean") or k.endswith(".bias"):
            out[k] = rng.normal(0, 0.1, tuple(v.shape)).astype(np.float32)
        else:
            out[k] = rng.uniform(0.2, 0.6, tuple(v.shape)).astype(np.float32)
    return out


def jax_trunk(name: str, sd):
    return jenc.ENCODERS[name][2](sd)


def port_model_trunk(name: str, jtree):
    """The JAX trunk tree crossed by ``from_jax_params``, as the port's
    trunk tree."""
    sd = convert.from_jax_params({}, jtree)
    module = tenc.frozen_module(tenc.init_encoder(name))
    module.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()})
    return tenc.module_tree(module)


@pytest.mark.parametrize("name", ["resnet152", "inception_v3"])
def test_trunk_features_match_jax(name):
    """The full-depth trunk at batch 1 in fp32: the pooled feature within
    1e-4 of its scale, through the weights the JAX converter built."""
    sd = fake_torchvision(name)
    jtree = jax_trunk(name, sd)
    size = SIZES[name]
    x = np.random.default_rng(4).random((1, size, size, 3)).astype(np.float32)
    want = np.asarray(jenc.ENCODERS[name][1](jtree, jnp.asarray(x)))
    got = tenc.encoder_apply(name)(port_model_trunk(name, jtree), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 2048)
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() / np.abs(want).max() <= TRUNK_RTOL


@pytest.mark.parametrize("name", ["resnet152", "inception_v3"])
def test_torchvision_converters_match_jax(name, tmp_path):
    """``from_torch_*`` gives the JAX converter's tree (OIHW for HWIO),
    ``to_torch_*`` gives the state dict back, and ``load_torch_encoder``
    reads a file of it into the same trunk entries."""
    sd = fake_torchvision(name, seed=5)
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    want = convert.from_jax_params({}, jax_trunk(name, sd))
    got = encoder_state_dict(tenc.ENCODERS[name][2](tsd))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    back = (tenc.to_torch_resnet152 if name == "resnet152" else tenc.to_torch_inception_v3)(
        tenc.ENCODERS[name][2](tsd))
    assert set(back) == set(tsd)
    assert all(torch.equal(back[k], tsd[k]) for k in tsd)
    torch.save(back, tmp_path / f"{name}.pth")
    loaded = encoder_state_dict(tenc.load_torch_encoder(name, str(tmp_path / f"{name}.pth")))
    assert all(torch.equal(loaded[k], want[k]) for k in want)
