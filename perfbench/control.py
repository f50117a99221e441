"""The readings that a cell's limits are set from, on the chip.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 0]

For each seed, in one process: the program's numbers as a run of the cell
computes them (its timed path at the cell's size, a window of ``--seconds``,
at least one call); the control's: the plain reference put in the
program's place and computed one precision below the configuration's
(``reference/lowp.fp8``), judged by the same comparison; and each planted
fault's (``harness/faults.py``: a serving cell's altered token always, on
the run's own served captions; those named by ``--faults``, each planted
in a run of its own, set-up and window). Prints one JSON line per seed.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)), os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

import torch  # noqa: E402

from harness import cell as cell_lib, faults  # noqa: E402
from harness.trace import Run  # noqa: E402
from reference import lowp  # noqa: E402


def readings(workload: str, seed: int, seconds: float, device="cuda", overrides=None, planted=()) -> dict:
    """The program's numbers, the control's, and each planted fault's: a
    serving cell's altered token is read on the run's own served captions,
    every fault of ``planted`` on a run of its own, set-up and window."""
    cell = cell_lib.Cell.find(workload, overrides)
    driver = cell_lib.driver(cell, seed, device, Run(cell.name))
    driver.setup()
    driver.window(seconds)
    driver.release()
    cell_lib.free_program()
    out = {"seed": seed, "program": driver.check(), "control": driver.control(lowp.fp8)}
    if hasattr(driver, "altered"):
        out["altered_token"] = driver.altered()
    del driver
    for name in planted:
        with faults.FAULTS[name](cell.vocab_size):
            d = cell_lib.driver(cell, seed, device, Run(cell.name))
            d.setup()
            d.window(seconds)
            d.release()
        cell_lib.free_program()
        out[name] = d.check()
        del d
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--faults", default="", help="comma-separated names of harness.faults to plant in set-up")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        planted = [f for f in args.faults.split(",") if f]
        print(json.dumps(readings(args.workload, int(s), args.seconds, planted=planted)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
