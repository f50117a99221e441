"""What the benchmark loads: nothing of JAX or the JAX package, and a
reference that imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from harness import cell

REF = os.path.join(cell.BENCH, "reference")


def test_run_and_every_module_it_runs_load_no_jax():
    """Import ``run.py``, every driver, reader and the reference in a fresh
    process and list the loaded top-level names, compared whole."""
    code = (
        "import sys, os, glob, importlib\n"
        f"sys.path[:0] = [{cell.BENCH!r}, {cell.ROOT!r}]\n"
        "import run\n"
        "for m in run.cell_lib.DRIVERS.values(): importlib.import_module(m)\n"
        "import control\n"
        "from reference import models, train, lowp\n"
        "import show_and_tell_tpu_torch.serve, show_and_tell_tpu_torch.train.step\n"
        f"for p in sorted(glob.glob(os.path.join({cell.BENCH!r}, 'metrics', '*.py'))):\n"
        "    run.metric_reader(os.path.basename(p)[:-3])\n"
        "print(','.join(run.forbidden_modules()))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.splitlines()[-1] == ""  # no forbidden name


def test_forbidden_names_are_compared_whole(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "show_and_tell_tpu_torch_extra", object())
    assert "show_and_tell_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "show_and_tell_tpu.config", object())
    assert run.forbidden_modules() == ["show_and_tell_tpu"]


@pytest.mark.parametrize("path", sorted(os.path.join(REF, f) for f in os.listdir(REF) if f.endswith(".py")))
def test_reference_imports_torch_numpy_and_itself_only(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "typing", "torch", "numpy", "reference", "math"}, names
