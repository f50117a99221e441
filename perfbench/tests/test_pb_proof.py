"""A model the harness has never seen comes in by new files alone.

The test copies ``BENCHMARK.json`` and ``perfbench/`` and adds, in the copy,
only what a configuration of a new model writes: its configuration, its
cell's limits, a model plug-in and a trunk plug-in, each under a name that
the harness has never seen, and list entries appended to
``BENCHMARK.json``. The model is the program's Show-and-Tell at two layers,
given the new name in the program's ``MODELS`` (and its trunk, ResNet-152,
a new name in ``ENCODERS``), with weight rules and weights drawn tensor by
tensor. The copy's own ``run_cell`` then runs the new cell on the CPU at a
tiny size, untraced and traced (the card's clocks stood in for by
``host_clock``), and once with a token altered where the decode produces
it. No file of the copy that was there before changes, but for the lists
appended to ``BENCHMARK.json``.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from harness import bounds, cell

MODEL, TRUNK = "caption_lm", "resnet152_pool"
CONFIG = "caption_lm_bf16"
CELL = CONFIG + ".bulk_beam3"
SEED = 2**31 + 2718
V = 40

MODEL_PLUGIN = '''"""Show-and-Tell's network under a name of its own."""

from harness import bounds, plugins
from harness.plugins import Wrap

ST = plugins.model("show_tell")


def reference(cfg, weights, q, trunk):
    return ST.ShowTell(weights, q, trunk, cfg.num_layers)


def step_flops(cfg, vocab):
    E, H = cfg.embed_size, cfg.hidden_size
    return 2.0 * (E + H) * 4 * H + (cfg.num_layers - 1) * 2.0 * (2 * H) * 4 * H + 2.0 * H * vocab


def model_flops(cfg, vocab, counters, trunk_flops):
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

RULES = [{"match": r"bn\.scale", "uniform": [0.9, 1.1]}, {"match": r"lstm\.1\.b", "constant": 0.0},
         {"match": r"proj\.w", "fan_in_axis": 0}]
TINY = {"model": {"embed_size": 16, "hidden_size": 24, "crop_size": 32, "max_decode_len": 8}, "vocab_size": V,
        "mix": {"images_per_call": 8, "image_px": 40, "check_sample": 6, "traced_calls": 1}}

DRIVE = '''
import json, sys
bench_dir, root = sys.argv[1], sys.argv[2]
sys.path[:0] = [bench_dir, bench_dir + "/tests", root]
from show_and_tell_tpu_torch.models import encoders, registry
from show_and_tell_tpu_torch.models.show_tell import ShowTell
registry.MODELS[{model!r}] = ShowTell
encoders.ENCODERS[{trunk!r}] = encoders.ENCODERS["resnet152"]
import host_clock
host_clock.install(setattr)
import run as bench
from harness import faults, trace
runs = []
class Kept(trace.Run):
    def __init__(self, cell):
        super().__init__(cell)
        runs.append(self)
bench.Run = Kept
tiny = json.loads(sys.argv[3])
out = {{"untraced": bench.run_cell({cell!r}, {seed}, 0.0, False, device="cpu", overrides=tiny)}}
out["traced"] = bench.run_cell({cell!r}, {seed}, 0.0, True, device="cpu", overrides=tiny)
out["counters"], out["unprofiled_s"] = dict(runs[-1].counters), runs[-1].unprofiled_s
with faults.altered_token({vocab}):
    out["altered"] = bench.run_cell({cell!r}, {seed}, 0.0, False, device="cpu", overrides=tiny)
out["loaded_from"] = sorted({{m.__file__ for m in list(sys.modules.values())
                             if getattr(m, "__file__", None) and "perfbench" in m.__file__}})
print(json.dumps(out))
'''.format(model=MODEL, trunk=TRUNK, cell=CELL, seed=SEED, vocab=V)


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


def append_cell(manifest):
    """The list entries a configuration of a new model appends: its
    configuration, its cell, and the cell's name on each metric that the
    serving cells report."""
    st = "st_resnet152_bf16.bulk_beam3"
    manifest["configs"].append({"name": CONFIG, "source": "https://arxiv.org/abs/1411.4555",
                                "file": f"perfbench/configs/{CONFIG}.json", "reduced": [],
                                "why": "Show-and-Tell at two LSTM layers under a new name"})
    manifest["workloads"].append({"name": CELL, "config": CONFIG, "traffic": "bulk_beam3", "chips": 1,
                                  "why": "the bulk traffic on a model the harness has not seen"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if st in m.get("workloads", ()):
            m["workloads"].append(CELL)


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    top = tmp_path_factory.mktemp("checkout")
    shutil.copy(os.path.join(cell.ROOT, "BENCHMARK.json"), top)
    shutil.copytree(cell.BENCH, top / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = hashes(top)
    config = json.load(open(os.path.join(cell.BENCH, "configs", "st_resnet152_bf16.json")))
    config.update(name=CONFIG, source="https://arxiv.org/abs/1411.4555",
                  weights={"head_gain": 150.0, "per_tensor": True, "rules": RULES})
    config["model"].update(model=MODEL, encoder=TRUNK, num_layers=2)
    add(top, f"perfbench/configs/{CONFIG}.json", json.dumps(config, indent=1))
    add(top, f"perfbench/limits/{CELL}.json", json.dumps({"score_err_nats": 1.7, "topk_gap_nats": 0.6}))
    add(top, f"perfbench/models/{MODEL}.py", MODEL_PLUGIN)
    add(top, f"perfbench/models/encoders/{TRUNK}.py", TRUNK_PLUGIN)
    manifest = json.load(open(top / "BENCHMARK.json"))
    old = json.loads(json.dumps(manifest))
    append_cell(manifest)
    with open(top / "BENCHMARK.json", "w") as fh:
        json.dump(manifest, fh, indent=1)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", DRIVE, str(top / "perfbench"), cell.ROOT, json.dumps(TINY)],
                          capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return top, before, old, json.loads(proc.stdout.splitlines()[-1])


def test_the_new_model_runs_correct_from_its_own_files(copy):
    top, _, _, out = copy
    for key in ("untraced", "traced"):
        assert out[key]["correct"], out[key]["checks"]
    assert out["untraced"]["metrics"].keys() == {"serve_img_s", "setup_s"}
    # the copy's harness ran, with the new plug-ins
    assert all(p.startswith(str(top)) for p in out["loaded_from"]), out["loaded_from"]
    assert {f"perfbench/models/{MODEL}.py", f"perfbench/models/encoders/{TRUNK}.py"} <= {
        os.path.relpath(p, top) for p in out["loaded_from"]}


def test_the_new_plugins_count_and_give_the_model_flops(copy):
    _, _, _, out = copy
    c, layers = out["counters"], 2
    E, H, images = 16, 24, 8
    assert c["trunk_images"] == images and c["caption_lm_rows"] > 0
    assert c["lstm_cell_calls"] % layers == 0 and "decode_row_cells" not in c
    step = 2.0 * (E + H) * 4 * H + 2.0 * (2 * H) * 4 * H + 2.0 * H * V
    flops = c["trunk_images"] * (_resnet_flops(32) + 2.0 * 2048 * E) + c["caption_lm_rows"] * step / layers
    assert c["model_flops"] == pytest.approx(flops, rel=1e-12)
    mfu = out["traced"]["metrics"]["mfu.serve"]["value"]
    assert mfu == pytest.approx(100.0 * flops / out["unprofiled_s"] / bounds.MFU_PEAK, rel=1e-12)
    assert "lstm_cell_roofline" not in out["traced"]["metrics"]  # no device time on the CPU: left out


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


def test_an_altered_token_fails_the_new_cell(copy):
    _, _, _, out = copy
    assert not out["altered"]["correct"]
    assert out["altered"]["checks"]["score_err_nats"]["value"] == 1e9


def test_no_file_that_was_there_changed(copy):
    top, before, old, _ = copy
    after = hashes(top)
    changed = {p for p, h in before.items() if after.get(p) != h}
    assert changed == {"BENCHMARK.json"}
    assert set(after) - set(before) == {f"perfbench/configs/{CONFIG}.json", f"perfbench/limits/{CELL}.json",
                                        f"perfbench/models/{MODEL}.py", f"perfbench/models/encoders/{TRUNK}.py"}
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
