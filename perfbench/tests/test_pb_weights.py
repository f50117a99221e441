"""The benchmark's weights: both configurations draw today's weights bit for
bit; a configuration's rules come before the built-in ones; and weights
drawn tensor by tensor reach the program and the reference alike, the
reference holding none of them."""

import gc
import math
import weakref

import pytest
import torch

from harness import cell as cell_lib, plugins, traffic, weights
from reference import models as ref

# --- a frozen copy of weights.make as both configurations draw it -------------------

_BN = {"scale": (0.5, 1.0), "bias": (-0.1, 0.1), "mean": (-0.1, 0.1), "var": (0.5, 1.5)}


def _frozen_interval(name, shape, head_gain):
    leaf = name.rsplit(".", 1)[-1]
    parent = name.rsplit(".", 2)[-2] if name.count(".") >= 1 else ""
    if "bn" in parent and leaf in _BN:
        if leaf == "scale" and parent in ("bn3", "down_bn"):
            return (0.1, 0.3)
        return _BN[leaf]
    if len(shape) == 4:
        s = math.sqrt(6.0 / (shape[1] * shape[2] * shape[3]))
        return -s, s
    if name == "embed":
        return -0.1, 0.1
    if name == "att.w_att":
        s = math.sqrt(6.0 / (shape[0] + 1))
        return -s, s
    if leaf == "b" and name.startswith("encoder."):
        return -0.05, 0.05
    if len(shape) == 2:
        s = 1.0 / math.sqrt(shape[0])
        if name.startswith(("classifier.", "out.")):
            s *= head_gain
        return -s, s
    return -0.05, 0.05


@torch.no_grad()
def frozen_make(shapes, seed, device, head_gain=1.0):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    flat = torch.rand(sum(sizes), generator=g, device=device, dtype=torch.float32)
    out = {}
    for n, part in zip(names, torch.split(flat, sizes)):
        lo, hi = _frozen_interval(n, shapes[n], head_gain)
        out[n] = part.view(shapes[n]).mul_(hi - lo).add_(lo)
        if n in ("classifier.b", "out.b"):
            out[n][:2] = -1.0e4
    return out


# --------------------------------------------------------------------------------------

SEED = 2**31 + 12345
M = {"embed_size": 16, "hidden_size": 24, "crop_size": 32, "max_decode_len": 8}
RULES = [{"match": r"bn\.scale", "uniform": [0.9, 1.1]}, {"match": r"lstm\.\d+\.b", "constant": 0.0},
         {"match": r"proj\.w", "fan_in_axis": 0}]


@pytest.mark.parametrize("name", ["sat_vgg16_bf16.bulk_beam3", "st_resnet152_bf16.bulk_beam3"])
def test_configurations_draw_todays_weights(name):
    c = cell_lib.Cell.find(name, {"model": M, "vocab_size": 40})
    assert set(c.config["weights"]) == {"head_gain"}  # no rules, one draw
    model, w = cell_lib.build_model(c, SEED, "cpu")
    want = frozen_make(weights.shapes_of(model.state_dict()), traffic.substream(SEED, traffic.WEIGHTS), "cpu",
                       c.config["weights"]["head_gain"])
    assert isinstance(w, dict) and set(w) == set(want)
    sd = model.state_dict()
    for k in want:
        assert torch.equal(w[k], want[k]) and torch.equal(sd[k], want[k]), k


def test_rules_come_before_the_built_in_ones():
    shapes = {"layers.0.norm.w": (64,), "layers.0.router.b": (8,), "layers.0.experts.w1": (8, 32, 16),
              "lstm.w": (8, 16), "encoder.convs.0.w": (4, 3, 3, 3)}
    rules = [{"match": r"layers\.\d+\.norm\.w", "uniform": [0.9, 1.1]},
             {"match": r".*router\.b", "constant": 0.0},
             {"match": r".*experts\.w\d", "fan_in_axis": 1}]
    got, plain = weights.make(shapes, 7, "cpu", rules=rules), frozen_make(shapes, 7, "cpu")
    assert 0.9 <= float(got["layers.0.norm.w"].min()) and float(got["layers.0.norm.w"].max()) < 1.1
    assert torch.equal(got["layers.0.router.b"], torch.zeros(8))
    s = 1 / math.sqrt(32)
    assert 0.8 * s < float(got["layers.0.experts.w1"].abs().max()) <= s
    # a tensor no rule names keeps the built-in rule and its place in the draw
    assert torch.equal(got["lstm.w"], plain["lstm.w"]) and torch.equal(got["encoder.convs.0.w"],
                                                                          plain["encoder.convs.0.w"])
    drawn = weights.Drawn({k: (v, torch.bfloat16) for k, v in shapes.items()}, 7, "cpu", rules=rules)
    assert torch.equal(drawn["layers.0.router.b"], torch.zeros(8)) and drawn["layers.0.norm.w"].dtype == torch.float32
    for bad in ({"match": "x"}, {"match": "x", "constant": 0, "uniform": [0, 1]}, {"match": "x", "scale": 2}):
        with pytest.raises(ValueError, match="weight rule"):
            weights.make(shapes, 7, "cpu", rules=[bad])


def per_tensor_st():
    c = cell_lib.Cell.find("st_resnet152_bf16.bulk_beam3", {
        "model": dict(M, num_layers=2, dtype="float32"), "vocab_size": 40,
        "weights": {"head_gain": 150.0, "per_tensor": True, "rules": RULES}})
    return c, *cell_lib.build_model(c, SEED, "cpu")


def test_per_tensor_weights_reach_the_program_and_the_reference_alike():
    c, model, w = per_tensor_st()
    assert isinstance(w, weights.Drawn)
    sd = model.state_dict()
    assert set(w) == set(weights.shapes_of(sd))
    for k in w:
        assert torch.equal(sd[k].float(), w[k]), k
    assert 0.9 <= float(w["bn.scale"].min()) and torch.equal(w["lstm.1.b"], torch.zeros(4 * 24))
    assert float(w["out.b"][:2].max()) == weights.NEVER
    # each tensor from its own substream: the same seed draws it again, another does not
    again = weights.Drawn(w.specs, w.seed, "cpu", 150.0, RULES)
    other = weights.Drawn(w.specs, w.seed + 1, "cpu", 150.0, RULES)
    assert torch.equal(again["lstm.0.w"], w["lstm.0.w"]) and not torch.equal(other["lstm.0.w"], w["lstm.0.w"])
    with pytest.raises(TypeError):
        w["lstm.0.w"] = torch.zeros(1)  # read-only


def test_the_reference_holds_at_most_one_drawn_tensor_per_read(monkeypatch):
    """The reference runs the trunk and the beam search over the mapping;
    after every read the tensors it has alive are at most the one just read,
    and none outlives the search."""
    c, model, w = per_tensor_st()
    cfg = c.port_config()
    del model
    reads, alive, most = [0], [0], [0]
    getitem = weights.Drawn.__getitem__

    def gone():
        alive[0] -= 1

    def counted(self, name):
        t = getitem(self, name)
        reads[0] += 1
        alive[0] += 1
        weakref.finalize(t, gone)
        most[0] = max(most[0], alive[0])
        return t

    monkeypatch.setattr(weights.Drawn, "__getitem__", counted)
    net = plugins.reference(cfg, w, {})
    with torch.no_grad():
        feats = ref.features_of(net, traffic.images(3, 40, 40, 9, "cpu"), cfg.crop_size)
        ref.beam_search(net, feats, cfg.beam_size, cfg.max_decode_len)
    del net, feats
    gc.collect()
    assert reads[0] > len(w) and most[0] == 1 and alive[0] == 0
