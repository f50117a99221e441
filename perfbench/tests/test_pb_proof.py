"""A model the harness has never seen comes in by new files alone.

Each case copies ``BENCHMARK.json`` and ``perfbench/`` and adds, in the
copy, only what a configuration of a new model writes: its configuration,
its cell's limits, a model plug-in (and a trunk plug-in where the trunk is
new), each under a name that the harness has never seen, and list entries
appended to ``BENCHMARK.json``. The copy's own ``run_cell`` then runs the
new cell on the CPU at a tiny size, untraced and traced (the card's clocks
stood in for by ``host_clock``), and once each with a token altered where
the decode produces it and with a decode that searches one beam (and the
decoder with its cache left in its old order at each step). No file of
the copy that was there before changes, but for the lists appended to
``BENCHMARK.json``.

- ``show_tell``: the program's Show-and-Tell at two layers, given a new
  name in the program's ``MODELS`` (and its trunk, ResNet-152, a new name in
  ``ENCODERS``), weights drawn tensor by tensor; every size a ``Config``
  field.
- ``decoder``: ``proof_decoder.CaptionDecoder``, a pre-norm transformer
  decoder over the VGG16 grid, whose shape comes only from the
  configuration's architecture keys (``Cell.arch``), with a key-value cache
  in the beam search's carry that ``decode.beam._gather_beams`` reorders at
  every step, and one cut listed in ``reduced``. Its reference plug-in reads
  the same keys and, at every step, runs the prefix and the words so far
  again with no cache.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from harness import bounds, cell

SEED = 2**31 + 2718
V = 40
MIX = {"images_per_call": 8, "image_px": 40, "check_sample": 6, "traced_calls": 1}
ST = "st_resnet152_bf16.bulk_beam3"

ST_PLUGIN = '''"""Show-and-Tell's network under a name of its own."""

from harness import bounds, plugins
from harness.plugins import Wrap

ST = plugins.model("show_tell")


def reference(cfg, weights, q, trunk, arch):
    return ST.ShowTell(weights, q, trunk, cfg.num_layers)


def step_flops(cfg, vocab):
    E, H = cfg.embed_size, cfg.hidden_size
    return 2.0 * (E + H) * 4 * H + (cfg.num_layers - 1) * 2.0 * (2 * H) * 4 * H + 2.0 * H * vocab


def model_flops(cfg, vocab, counters, trunk_flops, arch):
    per_image = trunk_flops + 2.0 * 2048 * cfg.embed_size
    return counters["trunk_images"] * per_image + counters["caption_lm_rows"] * step_flops(cfg, vocab) / cfg.num_layers


def _rows(params, x, h, c):
    return {"caption_lm_rows": x.shape[0]}


WRAPS = [Wrap("show_and_tell_tpu_torch.models.show_tell:lstm_cell", "lstm_cell", bounds.lstm_cell_call, _rows)]
'''

TRUNK_PLUGIN = '''"""ResNet-152 to its pool, under a name of its own."""

from harness import plugins

RESNET = plugins.encoder("resnet152")


def features(net, x):
    return RESNET.features(net, x)


def flops(cfg):
    return RESNET.flops(cfg)
'''

DECODER_PLUGIN = '''"""A pre-norm transformer decoder over the VGG16 grid, its shape from the
configuration's architecture keys alone: the grid, projected, is a prefix of
positions; then <start>; then the words. The plain reference runs, at every
step, the prefix and every word so far again, with no cache."""

import math

import torch
import torch.nn.functional as F

from harness import bounds
from harness.plugins import Wrap
from reference import models as ref

FEATURE = 512


class Decoder(ref.Net):
    def __init__(self, w, q, trunk, arch):
        super().__init__(w, q, trunk)
        self.D, self.heads, self.layers = arch["hidden_size"], arch["num_attention_heads"], arch["num_hidden_layers"]
        self.theta, self.eps = arch["rope_theta"], arch["rms_norm_eps"]

    def norm(self, x, name):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * self.w[name + ".g"]

    def rope(self, x):
        T, hd = x.shape[2], x.shape[3]
        inv = self.theta ** (-torch.arange(0, hd, 2, dtype=torch.float64) / hd)
        ang = (torch.arange(T, dtype=torch.float64)[:, None] * inv[None]).to(x.device)
        cos, sin = ang.cos().float(), ang.sin().float()
        x1, x2 = x[..., : hd // 2], x[..., hd // 2 :]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def logits(self, grid, words):
        """The next word's logits after the grid [N, L, 512], <start> and
        the words [N, t]."""
        N, D, H = grid.shape[0], self.D, self.heads
        start = torch.full((N, 1), ref.START_ID, dtype=torch.long, device=grid.device)
        x = torch.cat([self.lin(grid, "proj"), self.w["embed"][torch.cat([start, words], 1)]], 1)
        T, hd = x.shape[1], D // H
        later = torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1)
        for i in range(self.layers):
            p = f"layers.{i}."
            h = self.norm(x, p + "attn_norm")
            q, k, v = (self.lin(h, p + n).view(N, T, H, hd).transpose(1, 2) for n in "qkv")
            s = self.q(self.q(self.rope(q)) @ self.q(self.rope(k)).transpose(-1, -2)) / math.sqrt(hd)
            a = torch.softmax(s.masked_fill(later, float("-inf")), -1)
            x = x + self.lin(self.q(self.q(a) @ self.q(v)).transpose(1, 2).reshape(N, T, D), p + "o")
            x = x + self.lin(F.silu(self.lin(self.norm(x, p + "mlp_norm"), p + "up")), p + "down")
        return self.lin(self.norm(x[:, -1], "norm"), "out")

    def start(self, feats):
        return feats, torch.zeros((feats.shape[0], 0), dtype=torch.long, device=feats.device)

    def first(self, grid, words, B, k):
        words = words.repeat_interleave(k, 0)
        return words, self.logits(grid.repeat_interleave(k, 0), words)

    def step(self, grid, words, tok, k):
        words = torch.cat([words, tok[:, None]], 1)
        return words, self.logits(grid.repeat_interleave(k, 0), words)


def reference(cfg, weights, q, trunk, arch):
    return Decoder(weights, q, trunk, arch)


def grid(cfg):
    return (cfg.crop_size // 16) ** 2


def model_flops(cfg, vocab, counters, trunk_flops, arch):
    """Every image's trunk and projection; per layer, each position's
    products and each (position, earlier position) pair's two products; each
    row of logits."""
    D, Fw = arch["hidden_size"], arch["intermediate_size"]
    return (counters["trunk_images"] * (trunk_flops + 2.0 * grid(cfg) * FEATURE * D)
            + counters["decoder_positions"] * 2.0 * (4 * D * D + 2 * D * Fw)
            + counters["decoder_pairs"] * 4.0 * D + counters["decoder_logit_rows"] * 2.0 * D * vocab)


def _positions(p, x, cache, *opts):
    N, T, _ = x.shape
    P = 0 if cache is None else cache[0].shape[2]
    return {"decoder_positions": N * T, "decoder_pairs": N * (T * P + T * (T + 1) // 2)}


def _block_ms(p, x, cache, *opts):
    D, Fw = p["up"]["w"].shape
    n = _positions(p, x, cache)
    ops = n["decoder_positions"] * 2.0 * (4 * D * D + 2 * D * Fw) + n["decoder_pairs"] * 4.0 * D
    return ops / bounds.PEAK_FLOPS[x.dtype] * 1e3


def _rows(t, x, eps):
    return {"decoder_logit_rows": x.shape[0]}


def _head_ms(t, x, eps):
    return 2.0 * x.shape[0] * t["out"]["w"].numel() / bounds.PEAK_FLOPS[x.dtype] * 1e3


WRAPS = [Wrap("proof_decoder:block", "decoder_block", _block_ms, _positions),
         Wrap("proof_decoder:head", "decoder_head", _head_ms, _rows)]
'''

ARCH = {"hidden_size": 32, "intermediate_size": 64, "num_attention_heads": 4, "num_hidden_layers": 2,
        "rope_theta": 800000.0, "rms_norm_eps": 1e-5}


def show_tell_config():
    config = json.load(open(os.path.join(cell.BENCH, "configs", "st_resnet152_bf16.json")))
    config.update(name="caption_lm_bf16", source="https://arxiv.org/abs/1411.4555",
                  weights={"head_gain": 150.0, "per_tensor": True,
                           "rules": [{"match": r"bn\.scale", "uniform": [0.9, 1.1]},
                                     {"match": r"lstm\.1\.b", "constant": 0.0},
                                     {"match": r"proj\.w", "fan_in_axis": 0}]})
    config["model"].update(model="caption_lm", encoder="resnet152_pool", num_layers=2)
    return config


def decoder_config():
    return {
        "name": "tiny_decoder_bf16", "source": "https://arxiv.org/abs/1706.03762",
        "defines": "a pre-norm transformer decoder with RoPE and RMSNorm, its sizes as a config.json names them",
        "reduced": ["num_hidden_layers"], "published": {"num_hidden_layers": 4},
        "deployment": "two chips, each holding two whole layers as a stage of a pipeline; this chip holds one stage",
        "model": {"model": "tiny_decoder", "encoder": "vgg16", "crop_size": 224, "beam_size": 3, "max_decode_len": 20,
                  "length_penalty": 0.0, "dtype": "bfloat16"},
        "vocab_size": 10000, **ARCH,
        "weights": {"head_gain": 4.0, "rules": [{"match": r".*norm\.g", "uniform": [0.9, 1.1]}]},
    }


CASES = {
    "show_tell": {
        "model": "caption_lm", "config": show_tell_config, "why": "Show-and-Tell at two LSTM layers under a new name",
        "plugins": {"models/caption_lm.py": ST_PLUGIN, "models/encoders/resnet152_pool.py": TRUNK_PLUGIN},
        "limits": {"score_err_nats": 1.7, "topk_gap_nats": 0.6},
        "program": {"caption_lm": "show_and_tell_tpu_torch.models.show_tell:ShowTell"},
        "encoders": {"resnet152_pool": "resnet152"},
        "tiny": {"model": {"embed_size": 16, "hidden_size": 24, "crop_size": 32, "max_decode_len": 8}},
        "metrics": lambda m: True,  # every metric the ST cell reports: its LSTM cell too
        "faults": ["altered_token", "beam_width_1"],
    },
    "decoder": {
        "model": "tiny_decoder", "config": decoder_config,
        "why": "a transformer decoder with a beam-ordered cache, its shape from its architecture keys, cut in depth",
        "plugins": {"models/tiny_decoder.py": DECODER_PLUGIN},
        # sound runs read 0.03-0.20 / 0-0.08 over 12 seeds, the fp8 control at
        # least 0.42 / 0.54, the cache left in its old order 0.81 / 0.61
        "limits": {"score_err_nats": 0.35, "topk_gap_nats": 0.25},
        "program": {"tiny_decoder": "proof_decoder:CaptionDecoder"},
        "encoders": {},
        "tiny": {"model": {"crop_size": 32, "max_decode_len": 8}},
        "metrics": lambda m: not m["name"].endswith("_roofline"),  # no LSTM cell
        "faults": ["altered_token", "beam_width_1", "cache_not_reordered"],
    },
}

DRIVE = '''
import importlib, json, sys
bench_dir, root, spec = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
sys.path[:0] = [bench_dir, bench_dir + "/tests", root]
from show_and_tell_tpu_torch.models import encoders, registry
for name, target in spec["program"].items():
    module, attr = target.split(":")
    registry.MODELS[name] = getattr(importlib.import_module(module), attr)
for name, like in spec["encoders"].items():
    encoders.ENCODERS[name] = encoders.ENCODERS[like]
import host_clock
host_clock.install(setattr)
import run as bench
from harness import cell, faults, trace
runs = []
class Kept(trace.Run):
    def __init__(self, cell):
        super().__init__(cell)
        runs.append(self)
bench.Run = Kept
name, seed, tiny = spec["cell"], spec["seed"], spec["tiny"]
run = lambda traced=False: bench.run_cell(name, seed, 0.0, traced, device="cpu", overrides=tiny)
out = {"untraced": run()}
out["traced"] = run(True)
out["counters"], out["unprofiled_s"] = dict(runs[-1].counters), runs[-1].unprofiled_s
for fault in ("altered_token", "beam_width_1"):
    with faults.FAULTS[fault](tiny["vocab_size"]):
        out[fault] = run()
if "cache_not_reordered" in spec["faults"]:
    from show_and_tell_tpu_torch.decode import beam
    gather, beam._gather_beams = beam._gather_beams, lambda tree, parent, B, k: tree
    out["cache_not_reordered"] = run()
    beam._gather_beams = gather
out["arch"] = cell.Cell.find(name, tiny).arch
out["loaded_from"] = sorted({m.__file__ for m in list(sys.modules.values())
                             if getattr(m, "__file__", None) and "perfbench" in m.__file__})
print(json.dumps(out))
'''


def hashes(top):
    out = {}
    for d, dirs, files in os.walk(top):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, top)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def add(top, rel, text):
    path = os.path.join(top, rel)
    assert not os.path.exists(path), rel  # new files only
    with open(path, "w") as fh:
        fh.write(text)


def append_cell(manifest, case, config):
    """The list entries a configuration of a new model appends: its
    configuration, its cell, and the cell's name on each metric that the
    serving cells report and that it has something for."""
    name = config["name"]
    manifest["configs"].append({"name": name, "source": config["source"], "file": f"perfbench/configs/{name}.json",
                                "reduced": config["reduced"], "why": case["why"]})
    manifest["workloads"].append({"name": name + ".bulk_beam3", "config": name, "traffic": "bulk_beam3", "chips": 1,
                                  "why": "the bulk traffic on a model the harness has not seen"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if ST in m.get("workloads", ()) and case["metrics"](m):
            m["workloads"].append(name + ".bulk_beam3")


@pytest.fixture(scope="module", params=sorted(CASES))
def copy(request, tmp_path_factory):
    case = dict(CASES[request.param], case=request.param)
    top = tmp_path_factory.mktemp("checkout")
    shutil.copy(os.path.join(cell.ROOT, "BENCHMARK.json"), top)
    shutil.copytree(cell.BENCH, top / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = hashes(top)
    config = case["config"]()
    name = case["cell"] = config["name"] + ".bulk_beam3"
    case["added"] = {f"perfbench/configs/{config['name']}.json": json.dumps(config, indent=1),
                     f"perfbench/limits/{name}.json": json.dumps(case["limits"]),
                     **{f"perfbench/{rel}": text for rel, text in case["plugins"].items()}}
    for rel, text in case["added"].items():
        add(top, rel, text)
    manifest = json.load(open(top / "BENCHMARK.json"))
    old = json.loads(json.dumps(manifest))
    append_cell(manifest, case, config)
    with open(top / "BENCHMARK.json", "w") as fh:
        json.dump(manifest, fh, indent=1)
    spec = {"program": case["program"], "encoders": case["encoders"], "faults": case["faults"], "cell": name,
            "seed": SEED, "tiny": {**case["tiny"], "vocab_size": V, "mix": MIX}}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.setdefault("OMP_NUM_THREADS", "4")  # beside other test workers, few threads each
    proc = subprocess.run([sys.executable, "-c", DRIVE, str(top / "perfbench"), cell.ROOT, json.dumps(spec)],
                          capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return top, before, old, case, json.loads(proc.stdout.splitlines()[-1])


def test_the_new_model_runs_correct_from_its_own_files(copy):
    top, _, _, case, out = copy
    for key in ("untraced", "traced"):
        assert out[key]["correct"], out[key]["checks"]
    assert out["untraced"]["metrics"].keys() == {"serve_img_s", "setup_s"}
    # the copy's harness ran, with the new plug-ins
    assert all(p.startswith(str(top)) for p in out["loaded_from"]), out["loaded_from"]
    assert {f"perfbench/{rel}" for rel in case["plugins"]} <= {os.path.relpath(p, top) for p in out["loaded_from"]}


def test_the_architecture_and_its_cut_reach_the_cell(copy):
    _, _, _, case, out = copy
    if case["case"] == "show_tell":
        assert out["arch"] == {}  # every size a Config field
    else:
        assert out["arch"] == ARCH
        assert case["config"]()["reduced"] == ["num_hidden_layers"]


def test_the_new_plugins_count_and_give_the_model_flops(copy):
    _, _, _, case, out = copy
    c = out["counters"]
    images, E, H = MIX["images_per_call"], 16, 24
    assert c["trunk_images"] == images
    if case["case"] == "show_tell":
        layers = 2
        assert c["caption_lm_rows"] > 0 and c["lstm_cell_calls"] % layers == 0 and "decode_row_cells" not in c
        step = 2.0 * (E + H) * 4 * H + 2.0 * (2 * H) * 4 * H + 2.0 * H * V
        flops = c["trunk_images"] * (_resnet_flops(32) + 2.0 * 2048 * E) + c["caption_lm_rows"] * step / layers
    else:
        D, Fw, layers, grid = ARCH["hidden_size"], ARCH["intermediate_size"], ARCH["num_hidden_layers"], 4
        # each layer runs every image's grid and <start>, then one position per
        # row of logits after the first: the cache, not the prefix again
        rows = c["decoder_logit_rows"]
        assert rows > images and c["decoder_block_calls"] % layers == 0
        assert c["decoder_positions"] == layers * (images * (grid + 1) + rows - images)
        flops = (c["trunk_images"] * (_vgg_flops(32) + 2.0 * grid * 512 * D)
                 + c["decoder_positions"] * 2.0 * (4 * D * D + 2 * D * Fw) + c["decoder_pairs"] * 4.0 * D
                 + rows * 2.0 * D * V)
    assert c["model_flops"] == pytest.approx(flops, rel=1e-12)
    mfu = out["traced"]["metrics"]["mfu.serve"]["value"]
    assert mfu == pytest.approx(100.0 * flops / out["unprofiled_s"] / bounds.MFU_PEAK, rel=1e-12)
    assert "lstm_cell_roofline" not in out["traced"]["metrics"]  # no device time on the CPU, or no cell: left out


def _resnet_flops(crop):
    """ResNet-152's FLOPs at ``crop`` px, counted here on their own."""
    side = (crop + 2 * 3 - 7) // 2 + 1
    total = 2.0 * side * side * 64 * 3 * 49
    side = (side + 2 - 3) // 2 + 1
    cin = 64
    for li, (n, width) in enumerate(zip((3, 8, 36, 3), (64, 128, 256, 512))):
        for bi in range(n):
            stride = 2 if (li > 0 and bi == 0) else 1
            out_side = (side - 1) // stride + 1
            total += 2.0 * side * side * cin * width + 2.0 * out_side * out_side * width * width * 13
            if stride != 1 or cin != width * 4:
                total += 2.0 * out_side * out_side * cin * width * 4
            cin, side = width * 4, out_side
    return total


def _vgg_flops(crop):
    """VGG16's 13 convolutions to conv5_3's ReLU less the last, at ``crop`` px."""
    total, cin, side = 0.0, 3, crop
    for ch in (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512):
        if ch == "M":
            side //= 2
        else:
            total, cin = total + 2.0 * side * side * ch * cin * 9, ch
    return total


def test_a_broken_decode_fails_the_new_cell(copy):
    """A token altered, one beam searched, and for the decoder its cache
    left in its old order when the beams are reordered."""
    _, _, _, case, out = copy
    for fault in case["faults"]:
        assert not out[fault]["correct"], (fault, out[fault]["checks"])
    assert out["altered_token"]["checks"]["score_err_nats"]["value"] == 1e9


def test_no_file_that_was_there_changed(copy):
    top, before, old, case, _ = copy
    after = hashes(top)
    changed = {p for p, h in before.items() if after.get(p) != h}
    assert changed == {"BENCHMARK.json"}
    assert set(after) - set(before) == set(case["added"])
    new = json.load(open(top / "BENCHMARK.json"))
    for key in old:  # only appended: every old entry as it was, in its place
        if isinstance(old[key], list) and old[key] and isinstance(old[key][0], dict):
            assert len(new[key]) >= len(old[key])
            for a, b in zip(old[key], new[key]):
                assert {k: v for k, v in b.items() if k != "workloads"} == {
                    k: v for k, v in a.items() if k != "workloads"}
                assert b.get("workloads", [])[: len(a.get("workloads", []))] == a.get("workloads", [])
        else:
            assert new[key] == old[key]
