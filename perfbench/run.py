"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (``perfbench/configs/<config>.json``), a
traffic mix (``perfbench/traffic/<mix>.json``, whose ``kind`` picks the
driver) and its limits (``perfbench/limits/<cell>.json``). With
``--trace 0`` the metrics are the cell's end-to-end ones; with
``--trace 1`` a traced window gives its per-layer ones, each read by its
own file ``perfbench/metrics/<metric>.py``. Either way the served outputs
are then held against the plain reference (``perfbench/reference``), and
each number compared is printed beside its limit, last, on standard error
and under ``checks`` in the result line.

The program is ``show_and_tell_tpu_torch``. Nothing here imports JAX or
the JAX package, and a run that finds either loaded after its window fails.
"""

from __future__ import annotations

import os
import sys
import time

_T_IMPORT = time.time()


def process_start() -> float:
    """This process's start, by the clock of ``time.time()`` (Linux)."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as fh:
            boot = next(int(line.split()[1]) for line in fh if line.startswith("btime"))
        start = boot + ticks / os.sysconf("SC_CLK_TCK")
        return start if start <= _T_IMPORT else _T_IMPORT
    except (OSError, ValueError, IndexError, StopIteration):
        return _T_IMPORT


# the benchmark's own modules, then the checkout's root (the program)
sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)), os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402

import torch  # noqa: E402

from harness import cell as cell_lib  # noqa: E402
from harness.trace import Run  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "show_and_tell_tpu"}


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (``show_and_tell_tpu_torch`` is not ``show_and_tell_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def metric_reader(name: str):
    path = os.path.join(cell_lib.BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(manifest: dict, workload: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    e2e = [m for m in manifest["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if workload in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in names)]


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda", overrides=None) -> dict:
    """Set up, run the window, check, and return the result line's object
    (without the device's name and count, which the caller adds)."""
    manifest = cell_lib.manifest()
    cell = cell_lib.Cell.find(workload, overrides)
    run = Run(workload)
    driver = cell_lib.driver(cell, seed, device, run)
    driver.setup()
    setup_s = time.time() - process_start()
    metrics = {}
    wanted = metrics_of(manifest, workload, trace)
    if trace:
        driver.traced()
        for m in wanted:
            value = metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = driver.window(seconds)
        e2e["setup_s"] = setup_s
        for m in wanted:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
    attempted, failed = driver.attempted, getattr(driver, "failed", 0)
    driver.release()
    cell_lib.free_program()
    values = driver.check()
    checks = {k: {"value": values[k], "limit": limit} for k, limit in cell.limits.items()}
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": {"memory_peak_bytes": peak}}
    if trace and run.profile is not None:
        result["device"].update(busy_s=run.profile.busy_s, window_s=run.profile.window_s)
        result["breakdown"] = {"device_ops": run.profile.top_ops(), "idle_gaps": run.profile.idle_gaps()}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = cell_lib.Cell.find(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    result["device"].update(platform="gpu", kind=torch.cuda.get_device_name(0), count=chips)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}: refusing to report", file=sys.stderr)
        return 3
    print(f"perfbench: card {power_limit()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
