"""PyTorch port, Show-and-Tell's layers and trunks against the JAX package,
and the trunks' fused convolution epilogue against their plain path.

The BatchNorm layers and the pools at small shapes, and the full-depth
ResNet-152 (64 px) and Inception-v3 (139 px) at batch 1 in fp32, fed the
same numpy-seeded weights: a torchvision-named state dict goes through the
JAX package's ``from_torch_*`` converters, and the JAX trees cross to the
port by ``ckpt.convert.from_jax_params``. The port's own ``from_torch_*``
and ``to_torch_*`` are held against the JAX converters on the same dict.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from show_and_tell_tpu.models import encoders as jenc
from show_and_tell_tpu.models import layers as jlayers
from show_and_tell_tpu_torch.ckpt import convert
from show_and_tell_tpu_torch.ckpt.torch_import import encoder_state_dict
from show_and_tell_tpu_torch.models import encoders as tenc
from show_and_tell_tpu_torch.models import layers as tlayers
from show_and_tell_tpu_torch.obs import profiler

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


# --- the convolutions' fused epilogue ---------------------------------------------

FUSED_RTOL = 1e-5  # fp32: the fused path's trunk feature against the plain path's


def _emu_conv_relu(x, w, b, stride, padding, dilation, groups):
    """fp32 stand-in for ``torch.cudnn_convolution_relu``."""
    return torch.relu(F.conv2d(x, w, None, stride, padding, dilation, groups) + b[None, :, None, None])


def _emu_conv_add_relu(x, w, z, alpha, b, stride, padding, dilation, groups):
    """fp32 stand-in for ``torch.cudnn_convolution_add_relu``."""
    y = F.conv2d(x, w, None, stride, padding, dilation, groups)
    return torch.relu(y + alpha * z + b[None, :, None, None])


def _old_vgg16(params, images):
    """The VGG trunk as it ran before the fused epilogue."""
    x, ci = images.permute(0, 3, 1, 2), 0
    for ch in tenc._VGG_CHANNELS:
        if ch == "M":
            x = tlayers.max_pool(x, 2, 2)
        else:
            x = torch.relu(tlayers.conv2d(params["convs"][ci], x, stride=1, padding=1))
            ci += 1
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


def _old_resnet152(params, images):
    """The ResNet trunk as it ran before the fused epilogue."""
    x = images.permute(0, 3, 1, 2)
    x = torch.relu_(tlayers.conv_bn(params["stem_conv"], params["stem_bn"], x, stride=2, padding=3))
    x = tlayers.max_pool(x, 3, 2, padding=1)
    for li, blocks in enumerate(params["layers"]):
        for bi, p in enumerate(blocks):
            stride = 2 if (li > 0 and bi == 0) else 1
            y = torch.relu_(tlayers.conv_bn(p["conv1"], p["bn1"], x))
            y = torch.relu_(tlayers.conv_bn(p["conv2"], p["bn2"], y, stride=stride, padding=1))
            y = tlayers.conv_bn(p["conv3"], p["bn3"], y)
            if "down_conv" in p:
                x = tlayers.conv_bn(p["down_conv"], p["down_bn"], x, stride=stride)
            x = torch.relu_(y.add_(x))
    return tlayers.global_avg_pool(x)


def _basic_node(rng):
    return {"conv": {"w": torch.from_numpy(rng.normal(0, 0.2, (16, 8, 1, 3)).astype(np.float32))},
            "bn": _t(_bn_params(rng, 16))}


def _fusion_case(name):
    """(trunk params, images, the trunk as it is, as it was, convs a call)."""
    rng = np.random.default_rng(6)
    if name == "vgg16":
        params = tenc.init_vgg16(torch.Generator().manual_seed(6))
        for p in params["convs"]:
            p["b"] = torch.from_numpy(rng.normal(0, 0.1, tuple(p["b"].shape)).astype(np.float32))
        return params, rng.random((2, 32, 32, 3)).astype(np.float32), tenc.vgg16_features, _old_vgg16, 12
    if name == "resnet152":
        params = tenc.from_torch_resnet152({k: torch.from_numpy(v) for k, v in fake_torchvision(name).items()})
        return params, rng.random((1, 32, 32, 3)).astype(np.float32), tenc.resnet152_features, _old_resnet152, 151
    node = _basic_node(rng)
    return (node, rng.normal(0, 1, (2, 5, 7, 8)).astype(np.float32),
            lambda p, x: tenc._basic(p, x.permute(0, 3, 1, 2), 2, (0, 1)),
            lambda p, x: torch.relu_(tlayers.conv_bn(p["conv"], p["bn"], x.permute(0, 3, 1, 2), 2, (0, 1), eps=1e-3)),
            1)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _on_a_card(monkeypatch, relu=_emu_conv_relu, add_relu=_emu_conv_add_relu):
    """Take every tensor for one on a card in the path predicate (autograd
    still decides), and stand ``relu``/``add_relu`` in for cuDNN's fused
    ops; returns the calls they saw."""
    calls = []

    def fuses(x, *tensors):
        return not (torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, *tensors)))

    def seen(kind, fn):
        def op(*args):
            calls.append((kind, args))
            return fn(*args)
        return op

    for mod in (tlayers, tenc):
        monkeypatch.setattr(mod, "fuses_epilogue", fuses)
    monkeypatch.setattr(torch, "cudnn_convolution_relu", seen("relu", relu))
    monkeypatch.setattr(torch, "cudnn_convolution_add_relu", seen("add_relu", add_relu))
    return calls


def _refused(*args):
    raise RuntimeError("GET was unable to find an engine to execute this computation")


def _failed(*args):
    raise RuntimeError("cuDNN error: CUDNN_STATUS_EXECUTION_FAILED")


@pytest.mark.parametrize("name,refuse", [("vgg16", None), ("resnet152", None), ("resnet152", "engine"),
                                         ("resnet152", "fault"), ("basic", None)],
                         ids=["vgg16", "resnet152", "resnet152-residual-refused", "resnet152-residual-fault",
                              "basic"])
def test_fused_epilogue_matches_the_plain_trunk(name, refuse, one_thread, monkeypatch):
    """The fused branch, cuDNN's ops stood in for by fp32 emulations, gives
    the plain path's feature within 1e-5 of its scale in fp32; ResNet's
    shortcut convolutions run without bias, their shift merged into conv3's,
    and stay right where cuDNN has no engine for the residual call (each
    such call tried, warned of by its shapes, then run as separate passes).
    Any other error of the fused call propagates. Inside a recording every
    call counts in ``trunk.convs``, the fused ones in ``trunk.fused_convs``."""
    params, images, apply, _, convs = _fusion_case(name)
    x = torch.from_numpy(images)
    with torch.no_grad():
        want = apply(params, x)
        if refuse == "fault":
            _on_a_card(monkeypatch, add_relu=_failed)
            with pytest.raises(RuntimeError, match="EXECUTION_FAILED"):
                apply(params, x)
            return
        calls = _on_a_card(monkeypatch, add_relu=_refused if refuse else _emu_conv_add_relu)
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            with profiler.recording() as rec:
                got = apply(params, x)
            again = apply(params, x)
    adds = 50 if name == "resnet152" else 0
    assert torch.equal(got, again)
    assert rec.counters["trunk.convs"] == convs
    assert rec.counters["trunk.fused_convs"] == convs - (adds if refuse else 0)
    kinds = [k for k, _ in calls]
    assert kinds.count("add_relu") == 2 * adds and kinds.count("relu") == 2 * (convs - adds)
    assert all(args[-2:] == ((1, 1), 1) for _, args in calls)  # dilation, groups
    assert all(args[3] == 1.0 for k, args in calls if k == "add_relu")  # alpha
    engine = [str(w.message) for w in warned if "no fused engine" in str(w.message)]
    assert len(engine) == (2 * adds if refuse else 0)
    assert all("residual True" in m and "torch.float32" in m for m in engine)
    assert np.abs(want.numpy()).max() > 0
    assert np.abs(got.numpy() - want.numpy()).max() / np.abs(want.numpy()).max() <= FUSED_RTOL


@pytest.mark.parametrize("where", ["cpu", "autograd"])
@pytest.mark.parametrize("name", ["vgg16", "resnet152", "basic"])
def test_plain_path_runs_the_trunk_as_before(name, where, one_thread, monkeypatch):
    """On the CPU, and on a card where autograd needs the call (a trunk
    being fine-tuned), cuDNN's fused ops are never called and the feature
    is bit-identical to the trunk's separate passes as they were; the
    gradient reaches the weights."""
    params, images, apply, old, _ = _fusion_case(name)
    x = torch.from_numpy(images)
    want = old(params, x)
    if where == "autograd":
        _on_a_card(monkeypatch, relu=_refused, add_relu=_refused)
        w = params["convs"][0]["w"] if name == "vgg16" else (
            params["stem_conv"]["w"] if name == "resnet152" else params["conv"]["w"])
        w.requires_grad_(True)
        try:
            got = apply(params, x)
            got.sum().backward()
            assert w.grad is not None and w.grad.abs().sum() > 0
        finally:
            w.requires_grad_(False)
        got = got.detach()
    else:
        monkeypatch.setattr(torch, "cudnn_convolution_relu", _refused)
        monkeypatch.setattr(torch, "cudnn_convolution_add_relu", _refused)
        with torch.no_grad():
            got = apply(params, x)
    assert torch.equal(got, want)
