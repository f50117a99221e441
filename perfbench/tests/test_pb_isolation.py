"""What the benchmark loads: nothing of JAX or the JAX package, and a
reference and plug-ins that import nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from harness import cell

REF = os.path.join(cell.BENCH, "reference")
PLUGINS = [os.path.join(d, f) for d in (os.path.join(cell.BENCH, "models"),
                                        os.path.join(cell.BENCH, "models", "encoders"))
           for f in sorted(os.listdir(d)) if f.endswith(".py")]


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
        "from harness import plugins\n"
        f"for p in sorted(glob.glob(os.path.join({cell.BENCH!r}, 'models', '*.py'))):\n"
        "    plugins.model(os.path.basename(p)[:-3])\n"
        f"for p in sorted(glob.glob(os.path.join({cell.BENCH!r}, 'models', 'encoders', '*.py'))):\n"
        "    plugins.encoder(os.path.basename(p)[:-3])\n"
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


def imports(path):
    """The modules a file imports, whole (``from a import b`` as ``a.b``)."""
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names |= {f"{node.module}.{a.name}" for a in node.names}
    return names


BASE = {"__future__", "typing", "torch", "numpy", "reference", "math"}


@pytest.mark.parametrize("path", sorted(os.path.join(REF, f) for f in os.listdir(REF) if f.endswith(".py")))
def test_reference_imports_torch_numpy_and_itself_only(path):
    names = {n.split(".")[0] for n in imports(path)}
    assert names <= BASE, names


@pytest.mark.parametrize("path", PLUGINS, ids=[os.path.relpath(p, cell.BENCH) for p in PLUGINS])
def test_plugins_import_nothing_of_the_program(path):
    """A plug-in reads the reference and the yardstick's arithmetic; it names
    the program's entry points as strings only."""
    for name in imports(path):
        top = name.split(".")[0]
        assert top in BASE or name in {"harness.bounds", "harness.plugins.Wrap", "harness.plugins"}, name
