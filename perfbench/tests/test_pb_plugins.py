"""Each model's and each trunk's pieces come from its plug-in, found by name:
a missing plug-in stops set-up with its file's path, never another's
numbers; and a traced serving run counts what it counted before the
plug-ins held the wraps."""

import collections
import os

import pytest

import host_clock
from harness import bounds, cell as cell_lib, instrument, plugins
from harness.trace import Run

SEED = 2**31 + 4242
M = {"embed_size": 16, "hidden_size": 24, "crop_size": 32, "max_decode_len": 8}
TINY = {"model": M, "vocab_size": 40, "mix": {"images_per_call": 8, "image_px": 40, "check_sample": 6}}
SAT, ST = "sat_vgg16_bf16.bulk_beam3", "st_resnet152_bf16.bulk_beam3"


def driver(name, model=None):
    cell = cell_lib.Cell.find(name, dict(TINY, model=dict(M, **(model or {}))))
    return cell_lib.driver(cell, SEED, "cpu", Run(name))


@pytest.mark.parametrize("name,model,path", [
    (SAT, {"model": "no_such_model"}, "perfbench/models/no_such_model.py"),
    (ST, {"encoder": "no_such_trunk"}, "perfbench/models/encoders/no_such_trunk.py"),
    ("sat_vgg16_bf16.train_b128", {"model": "no_such_model"}, "perfbench/models/no_such_model.py"),
])
def test_a_missing_plugin_stops_setup(name, model, path):
    with pytest.raises(SystemExit, match=path):
        driver(name, model).setup()


def test_an_inception_v3_trunk_is_its_own_or_stops():
    """Show-and-Tell on Inception-v3 reads Inception-v3's FLOPs or none:
    never ResNet-152's, the model's other trunk."""
    cfg = cell_lib.Cell.find(ST, {"model": {"encoder": "inception_v3"}}).port_config()
    counters = {"trunk_images": 1.0, "decode_row_cells": 0.0}
    if os.path.isfile(os.path.join(plugins.BENCH, "models", "encoders", "inception_v3.py")):
        resnet = plugins.model("show_tell").model_flops(cfg, 10000, counters,
                                                        plugins.encoder("resnet152").flops(cfg), {})
        assert plugins.model_flops(cfg, 10000, counters, {}) != resnet
    else:
        with pytest.raises(SystemExit, match="perfbench/models/encoders/inception_v3.py"):
            plugins.model_flops(cfg, 10000, counters, {})
        with pytest.raises(SystemExit, match="perfbench/models/encoders/inception_v3.py"):
            driver(ST, {"encoder": "inception_v3"}).setup()


# the program's entry points that traced runs wrapped before the plug-ins
# named them, and the counters each call added then
def _cell(counts, params, x, h, c):
    B, I = x.shape
    counts["lstm_cell_calls"] += 1
    counts["lstm_cell_bound_s"] += bounds.cell_bound(B, I, h.shape[1], x.dtype) / 1e3
    counts["decode_row_cells"] += B


def _attention(counts, ce, f, hp, watt, *a, **kw):
    B, L, D = ce.shape
    counts["attention_beam_calls"] += 1
    counts["attention_beam_bound_s"] += bounds.attention_bound(B, hp.shape[1], L, D, ce.dtype) / 1e3


BEFORE = {
    SAT: [("show_and_tell_tpu_torch.models.show_attend_tell", "lstm_cell", _cell),
          ("show_and_tell_tpu_torch.models.show_attend_tell", "attention_beam", _attention)],
    ST: [("show_and_tell_tpu_torch.models.show_tell", "lstm_cell", _cell)],
}


@pytest.mark.parametrize("name", [SAT, ST])
def test_wrap_counters_as_before(name, monkeypatch):
    import importlib

    from show_and_tell_tpu_torch import serve

    host_clock.install(monkeypatch.setattr)
    d = driver(name)
    d.setup()
    want = collections.defaultdict(float)

    def spy(count, orig):
        def call(*a, **kw):
            count(want, *a, **kw)
            return orig(*a, **kw)

        return call

    for module, attr, count in BEFORE[name]:
        mod = importlib.import_module(module)
        monkeypatch.setattr(mod, attr, spy(count, getattr(mod, attr)))
    features = serve.Captioner._features

    def counted_features(self, chunk):
        out = features(self, chunk)
        want["trunk_images"] += out.shape[0]
        return out

    monkeypatch.setattr(serve.Captioner, "_features", counted_features)
    with instrument.serving(d.run, d.wraps, decode_timer=False):
        d._call()
        d._call()
    assert want["lstm_cell_calls"] > 0 and dict(d.run.counters) == dict(want)
