"""The trunks' fused convolution epilogue on the card (``card`` marker; each
test skips without a CUDA device). The module imports nothing of JAX, so on
a machine without JAX run it without ``tests/conftest.py``:
``python -m pytest --noconftest tests/test_torch_port_trunk_fusion.py -q``.

Every convolution of VGG16, ResNet-152 and Inception-v3 that carries a
bias, a ReLU or a residual add is one cuDNN call on the card
(``layers.conv_relu``), held against the same call as separate passes, at
the serving cells' shapes: a chunk of 256 images of the trunk's size
(224 px, Inception's 299 px), random weights of the trunks' widths. The
trunk prepared once per weight version gives the per-call fold's features
bit for bit at that chunk.
"""

import pytest
import torch
import torch.nn.functional as F

from show_and_tell_tpu_torch.models import encoders as tenc
from show_and_tell_tpu_torch.models import layers as tlayers
from show_and_tell_tpu_torch.obs import profiler

pytestmark = pytest.mark.card

CHUNK = 256  # the serving cells' chunk
# bf16, one call: the separate passes round the convolution, the bias add and
# the residual add (three roundings), the fused epilogue rounds once at the
# end; each rounding is within 2^-8 of its value, so the two differ by at
# most 4 * 2^-8 of the largest of conv, conv + b and conv + b + z.
BF16_CALL_RTOL = 4 * 2.0 ** -8
F32_RTOL = 1e-4  # fp32, TF32 off: the whole trunk's feature
CONVS = {"vgg16": 12, "resnet152": 151, "inception_v3": 94}
PX = {"vgg16": 224, "resnet152": 224, "inception_v3": 299}
TRUNKS = list(CONVS)


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none. Decided here,
    never while the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda")


def _trunk(name, device):
    """Trunk params in fp32 on ``device``, as the models hold them: He-normal
    convs, biases N(0, 0.1), BatchNorm scales U(0.2, 0.6), shifts and means
    N(0, 0.1), variances U(0.5, 2)."""
    g = torch.Generator().manual_seed(21)
    tree = tenc.init_encoder(name, g)

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

    return _to(fill(tree), device)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _images(name, n, device, dtype):
    g = torch.Generator(device=device).manual_seed(7)
    return torch.randn(n, PX[name], PX[name], 3, generator=g, device=device).to(dtype)


def _plain(monkeypatch):
    for mod in (tlayers, tenc):
        monkeypatch.setattr(mod, "fuses_epilogue", lambda x, *t: False)


@pytest.mark.parametrize("name", TRUNKS)
def test_fused_calls_match_separate_passes_in_bf16(name, card, monkeypatch):
    """Each fused call against the same call as separate passes, on the fused
    trunk's own activations: within 4 * 2^-8 of the largest intermediate
    (``BF16_CALL_RTOL``); every call took the fused path."""
    params = _trunk(name, card)
    worst = []
    real = tlayers.conv_relu

    def checked(x, w, b, stride=1, padding=0, z=None):
        y = real(x, w, b, stride, padding, z)
        sep = F.conv2d(x, w, b, stride=stride, padding=padding)
        if z is not None:
            sep = sep.add_(z)
        sep = torch.relu_(sep)
        c = F.conv2d(x.float(), w.float(), None, stride=stride, padding=padding)
        cb = c + b.float()[None, :, None, None]
        scale = max(c.abs().max(), cb.abs().max(), (cb + z.float()).abs().max() if z is not None else 0)
        worst.append(float((y.float() - sep.float()).abs().max() / scale))
        return y

    for mod in (tlayers, tenc):
        monkeypatch.setattr(mod, "conv_relu", checked)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the fp32 scale exact
    try:
        with torch.no_grad(), profiler.recording() as rec:
            tenc.encoder_apply(name)(params, _images(name, CHUNK, card, torch.bfloat16))
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert len(worst) == CONVS[name]
    assert max(worst) <= BF16_CALL_RTOL, worst
    assert rec.counters["trunk.fused_convs"] == rec.counters["trunk.convs"] == CONVS[name]


@pytest.mark.parametrize("name", TRUNKS)
def test_fused_trunk_matches_the_plain_one_in_fp32(name, card, monkeypatch):
    """fp32 with TF32 off: the fused trunk's feature within 1e-4 of its scale
    of the plain trunk's (the separate passes, as on the CPU)."""
    params = _trunk(name, card)
    x = _images(name, 16, card, torch.float32)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad(), profiler.recording() as rec:
            got = tenc.encoder_apply(name)(params, x)
        with torch.no_grad(), monkeypatch.context() as m:
            _plain(m)
            want = tenc.encoder_apply(name)(params, x)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert rec.counters["trunk.fused_convs"] == rec.counters["trunk.convs"] == CONVS[name]
    assert want.abs().max() > 0
    assert float((got - want).abs().max() / want.abs().max()) <= F32_RTOL


@pytest.mark.parametrize("name", TRUNKS)
def test_prepared_trunk_matches_the_per_call_fold(name, card):
    """At a serving chunk in bf16, under ``inference_mode`` as the serving
    path runs: the trunk prepared once (``encoders.PreparedTrunk``) gives
    the per-call fold's features bit for bit, in the call that prepares and
    in the two that reuse it, with every call fused."""
    params = _trunk(name, card)
    x = _images(name, CHUNK, card, torch.bfloat16)
    prep = tenc.PreparedTrunk()
    with torch.inference_mode(), profiler.recording() as rec:
        want = tenc.encoder_apply(name)(params, x)
        got = [tenc.trunk_features(name, params, x, prep) for _ in range(3)]
    assert want.abs().max() > 0
    assert all(torch.equal(g, want) for g in got)
    assert (rec.counters["trunk.prepares"], rec.counters["trunk.prepared_calls"]) == (1, 2)
    assert rec.counters["trunk.fused_convs"] == rec.counters["trunk.convs"] == 4 * CONVS[name]
