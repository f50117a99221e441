"""``BENCHMARK.json`` against the contract's rules on names, units and
files, and every piece it names found by name."""

import json
import os
import re

import pytest

from harness import cell, plugins

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = cell.manifest()
CELLS = [w["name"] for w in M["workloads"]]
UNCUT = ("sat_vgg16_bf16", "st_resnet152_bf16")


def test_top_level_keys_and_limits():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert 1 <= len(M["configs"]) <= 24 and 1 <= len(M["workloads"]) <= 24
    assert 1 <= len(M["end_to_end"]) <= 16 and 1 <= len(M["per_layer"]) <= 128
    assert len(json.dumps(M)) <= 64 * 1024
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p
               for p in M["paths"])
    assert len(M["command"]) <= 32


def test_names_and_units():
    names = [x["name"] for x in M["configs"] + M["workloads"] + M["end_to_end"] + M["per_layer"]]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in M[group]}) == len(M[group])
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [c["why"] for c in M["configs"]] + [w["why"] for w in M["workloads"]] + \
            [m["layer"] for m in M["per_layer"]] + [c["source"] for c in M["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in CELLS:  # setup_s and one more end-to-end metric, and a per-layer one, in every cell
        reported = [m for m in M["end_to_end"] if w in m.get("workloads", [w])]
        assert len(reported) >= 2
        assert any(w in m["workloads"] for m in M["per_layer"])


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert all(w in e2e[m["moves"]].get("workloads", [w]) for w in m["workloads"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("w", M["workloads"], ids=CELLS)
def test_each_cell_finds_its_files(w):
    c = cell.Cell.find(w["name"])
    assert w["name"] == f"{w['config']}.{w['traffic']}" and w["chips"] in (1, 4)
    assert c.mix["kind"] in ("bulk", "train") and c.limits
    cfg = next(x for x in M["configs"] if x["name"] == w["config"])
    assert cfg["file"] == f"perfbench/configs/{w['config']}.json" and cfg["reduced"] == c.config["reduced"]
    assert c.config["source"] == cfg["source"]
    # each cut documented: set in the file, its published value beside it and
    # differing, and the deployment it stands for (``cell.check_config``,
    # which ``Cell.find`` ran, stops set-up otherwise)
    for key in c.config["reduced"]:
        assert key == "vocab_size" or key in c.arch
        assert c.config["published"][key] != c.config[key]
        assert c.config["deployment"].strip()
    if w["config"] in UNCUT:  # every size a Config field, nothing cut
        assert c.config["reduced"] == [] and c.arch == {}
    model, trunk = plugins.of(c.port_config())  # its model's and its trunk's plug-ins
    assert callable(model.reference) and callable(model.model_flops) and callable(trunk.features)


@pytest.mark.parametrize("m", M["per_layer"], ids=[m["name"] for m in M["per_layer"]])
def test_each_per_layer_metric_has_a_reader(m):
    path = os.path.join(cell.BENCH, "metrics", m["name"] + ".py")
    assert os.path.isfile(path)
    assert "def read(run)" in open(path).read()
