"""PyTorch port: the trunks' convolution weights prepared once per weight
version (``models.encoders.PreparedTrunk``), on the CPU.

VGG16, ResNet-152 and Inception-v3 at full width, two small images (32 px;
Inception's 75 px, the least it takes), random weights with BatchNorm
statistics away from the identity. The prepared trunk gives the features
of a fresh per-call preparation bit for bit, prepares again after any
change to a weight, counts ``trunk.prepares`` and ``trunk.prepared_calls``
inside a recording, keeps nothing where a tensor needs grad or has no
version counter, and serves ``no_grad`` and ``inference_mode`` calls from
one preparation.
"""

import functools

import pytest
import torch

from show_and_tell_tpu_torch.config import Config
from show_and_tell_tpu_torch.models import encoders as tenc
from show_and_tell_tpu_torch.models.registry import build_model
from show_and_tell_tpu_torch.obs import profiler

TRUNKS = ["vgg16", "resnet152", "inception_v3"]
PX = {"vgg16": 32, "resnet152": 32, "inception_v3": 75}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _weights(name):
    """The trunk's tree with He-normal convs, biases N(0, 0.1), BatchNorm
    scales U(0.2, 0.6), shifts and means N(0, 0.1), variances U(0.5, 2)."""
    g = torch.Generator().manual_seed(25)

    def fill(t):
        if isinstance(t, list):
            return [fill(v) for v in t]
        if set(t) == {"scale", "bias", "mean", "var"}:
            c = t["scale"].shape
            return {"scale": torch.rand(c, generator=g) * 0.4 + 0.2, "bias": torch.randn(c, generator=g) * 0.1,
                    "mean": torch.randn(c, generator=g) * 0.1, "var": torch.rand(c, generator=g) * 1.5 + 0.5}
        if "w" in t:
            return {k: (v if k == "w" else torch.randn(v.shape, generator=g) * 0.1) for k, v in t.items()}
        return {k: fill(v) for k, v in t.items()}

    return fill(tenc.init_encoder(name, g))


def _module(name, scale=1.0):
    """A frozen module of the trunk's weights (times ``scale``), as a model
    holds it."""
    tree = _weights(name)

    def scaled(t):
        if isinstance(t, list):
            return [scaled(v) for v in t]
        if isinstance(t, dict):
            return {k: scaled(v) for k, v in t.items()}
        return t * scale

    return tenc.frozen_module(scaled(tree))


def _images(name, dtype=torch.float32):
    g = torch.Generator().manual_seed(3)
    return torch.randn(2, PX[name], PX[name], 3, generator=g).to(dtype)


def _fresh(name, module, x):
    """The features with every convolution's weights prepared in the call."""
    return tenc.encoder_apply(name)(tenc.module_tree(module), x)


def _cached(name, module, x, prep):
    return tenc.trunk_features(name, tenc.module_tree(module), x, prep)


def _some_tensor(name, tree, leaf):
    """A tensor of the tree's first convolution (``w``) or BatchNorm
    (``var``; VGG16's first bias where it has none)."""
    if name == "vgg16":
        return tree["convs"][0]["w" if leaf == "w" else "b"]
    node = tree["stem_conv"] if name == "resnet152" else tree["Conv2d_1a_3x3"]["conv"]
    if leaf == "w":
        return node["w"]
    return tree["stem_bn"]["var"] if name == "resnet152" else tree["Conv2d_1a_3x3"]["bn"]["var"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", TRUNKS)
def test_prepared_features_equal_a_fresh_preparation(name, dtype):
    """The call that prepares and the two that reuse give the per-call
    preparation's features bit for bit, in fp32 and bf16."""
    module, prep, x = _module(name), tenc.PreparedTrunk(), _images(name, dtype)
    with torch.no_grad():
        want = _fresh(name, module, x)
        got = [_cached(name, module, x, prep) for _ in range(3)]
    assert want.dtype == dtype and want.abs().max() > 0
    assert all(torch.equal(g, want) for g in got)
    assert prep.entries  # the memo held the weights


@pytest.mark.parametrize("change", ["load_state_dict", "copy_"])
@pytest.mark.parametrize("name", TRUNKS)
def test_a_weight_change_prepares_again(name, change):
    """After ``load_state_dict`` of other weights, or a ``copy_`` into one
    BatchNorm variance (VGG16: a bias), the next call gives the new
    weights' features, as a freshly built module does (bf16, so that every
    trunk keeps copies)."""
    module, prep, x = _module(name), tenc.PreparedTrunk(), _images(name, torch.bfloat16)
    with torch.no_grad():
        before = _cached(name, module, x, prep)
        if change == "load_state_dict":
            fresh = _module(name, scale=0.9)
            module.load_state_dict(fresh.state_dict())
        else:
            fresh = _module(name)
            for m in (module, fresh):
                t = _some_tensor(name, tenc.module_tree(m), "var")
                t.copy_(t * 1.5)
        got = _cached(name, module, x, prep)
        want = _fresh(name, fresh, x)
    assert not torch.equal(got, before)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", TRUNKS)
def test_counters_prepare_once_per_weight_version(name):
    """Three calls count one preparation and two reuses; a weight change
    makes the next call prepare again."""
    module, prep, x = _module(name), tenc.PreparedTrunk(), _images(name)
    with torch.no_grad(), profiler.recording() as rec:
        for _ in range(3):
            _cached(name, module, x, prep)
        assert (rec.counters["trunk.prepares"], rec.counters["trunk.prepared_calls"]) == (1, 2)
        _some_tensor(name, tenc.module_tree(module), "w").mul_(1.0)  # the version moves, not the values
        _cached(name, module, x, prep)
        _cached(name, module, x, prep)
    assert (rec.counters["trunk.prepares"], rec.counters["trunk.prepared_calls"]) == (2, 3)


@pytest.mark.parametrize("name", TRUNKS)
def test_a_trunk_that_needs_grad_prepares_every_call(name):
    """With one trunk tensor requiring grad nothing is kept or counted (a
    memo made while it was frozen is dropped), the features are the fresh
    preparation's, and a backward pass reaches that tensor."""
    module, prep, x = _module(name), tenc.PreparedTrunk(), _images(name)
    with torch.no_grad():
        _cached(name, module, x, prep)
    assert prep.entries
    w = _some_tensor(name, tenc.module_tree(module), "w")
    w.requires_grad_(True)
    with profiler.recording() as rec:
        got = [_cached(name, module, x, prep) for _ in range(2)]
    got[1].sum().backward()
    assert w.grad is not None and w.grad.abs().sum() > 0
    assert prep.entries is None and not rec.counters["trunk.prepares"] and not rec.counters["trunk.prepared_calls"]
    assert torch.equal(got[0], _fresh(name, module, x))


@pytest.mark.parametrize("name", TRUNKS)
def test_an_inference_tensor_weight_prepares_every_call(name):
    """A weight made under ``inference_mode`` has no version counter: the
    trunk is prepared in every call, with the same features."""
    tree, prep, x = tenc.module_tree(_module(name)), tenc.PreparedTrunk(), _images(name)
    with torch.inference_mode():
        want = tenc.encoder_apply(name)(tree, x)
        node = tree["convs"][0] if name == "vgg16" else (
            tree["stem_conv"] if name == "resnet152" else tree["Conv2d_1a_3x3"]["conv"])
        node["w"] = node["w"].clone()
        assert node["w"].is_inference()
        with profiler.recording() as rec:
            got = tenc.trunk_features(name, tree, x, prep)
    assert prep.entries is None and not rec.counters["trunk.prepares"]
    assert torch.equal(got, want)


@pytest.mark.parametrize("first", ["inference_mode", "no_grad"])
@pytest.mark.parametrize("name", TRUNKS)
def test_one_preparation_serves_inference_mode_and_no_grad(name, first):
    """Prepared under one of ``inference_mode`` and ``no_grad``, the trunk
    serves a call under the other from the same preparation, bit for bit,
    and the kept weights are ordinary tensors."""
    module, prep, x = _module(name), tenc.PreparedTrunk(), _images(name, torch.bfloat16)
    modes = [torch.inference_mode, torch.no_grad]
    if first == "no_grad":
        modes.reverse()
    got = []
    with profiler.recording() as rec:
        for mode in modes:
            with mode():
                got.append(_cached(name, module, x, prep))
    with torch.no_grad():
        want = _fresh(name, module, x)
    assert (rec.counters["trunk.prepares"], rec.counters["trunk.prepared_calls"]) == (1, 1)
    assert all(torch.equal(g, want) for g in got)
    kept = [t for entry in prep.entries.values() for t in entry if t is not None]
    assert kept and not any(t.is_inference() for t in kept)


@pytest.mark.parametrize("model,name", [("show_attend_tell", "vgg16"), ("show_tell", "resnet152"),
                                        ("show_tell", "inception_v3")])
def test_models_run_their_trunk_prepared(model, name):
    """``backbone_features`` of both models goes through the model's own
    ``PreparedTrunk``: the features are the per-call preparation's, and a
    ``load_state_dict`` of the model prepares again."""
    cfg = Config(model=model, encoder=name, embed_size=16, hidden_size=24, crop_size=PX[name],
                 dtype="bfloat16")
    m = build_model(cfg, 30, device="cpu")
    m.encoder.load_state_dict(_module(name).state_dict())
    x = _images(name)
    with profiler.recording() as rec:
        got = [m.backbone_features(x) for _ in range(2)]
        m.load_state_dict(m.state_dict())
        again = m.backbone_features(x)
    with torch.no_grad():
        want = _fresh(name, m.encoder, x.to(torch.bfloat16))
    assert all(torch.equal(g, want) for g in (*got, again))
    assert (rec.counters["trunk.prepares"], rec.counters["trunk.prepared_calls"]) == (2, 1)
