"""Epoch-chain supervisor: an N-epoch training as a chain of child processes,
one epoch each, resuming between them.

Long runs die of causes outside the training loop: host memory leaks,
scheduler preemptions, hung transfers. The ``Trainer`` turns SIGTERM
(``train/preempt.PreemptionGuard``) and host memory pressure (``RssWatchdog``,
``--rss_preempt_gb``) into a clean save of the whole train state; the
supervisor makes an unattended multi-epoch run of that:

    spawn ``cli.main --start_from <expr> --max_epochs k``   (one epoch)
      -> clean exit: epoch k is complete, go on to k+1
      -> preempted (watchdog, SIGTERM, ``--child_timeout_s``): respawn; the
         child resumes mid-epoch bit for bit
      -> crash: respawn from the last saved state; a respawn that makes no
         progress counts against ``--max_retries``

Each child is a fresh process, so a per-process leak lasts at most one epoch
and the watchdog's threshold. The children run on the GPU::

    python -m show_and_tell_tpu_torch.cli.train_chain --max_epochs 5 \
        --rss_preempt_gb 100 --data_json ... --vocab_path ...

``chain.json`` in the experiment dir records every spawn (epoch, attempt,
exit code, seconds, preempted, total_iter reached, progress).

Three behaviours differ from the JAX package's ``cli/train_chain.py`` on
purpose (ROADMAP.md §C):
- a SIGTERM to the supervisor terminates the running child (SIGTERM, then
  SIGKILL after ``--term_grace_s``) before the supervisor exits, so no
  orphaned child goes on writing the experiment dir;
- ``--start_from`` is rejected: the chain resumes its own experiment dir;
- without a readable ``chain.json``, the epoch of ``infos.json`` is run
  again instead of being counted as complete: infos written at a mid-epoch
  gate look like those of a finished epoch, and the child resumes the epoch
  at its ``iter``, running no step if it had ended.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import signal
import subprocess
import sys
import time
from typing import Callable, List, Optional

from show_and_tell_tpu_torch import ckpt
from show_and_tell_tpu_torch.config import Config, parse_config

log = logging.getLogger(__name__)

#: the module every link of the chain runs
CHILD_MODULE = "show_and_tell_tpu_torch.cli.main"


def resolved_expr_dir(cfg: Config) -> str:
    """The directory that cli.main's ``make_experiment_dir`` resolves to."""
    return os.path.join(cfg.expr_dir, cfg.user_id, cfg.exp_id)


def child_argv(cfg: Config, upto_epoch: int) -> List[str]:
    """argv of one link: train through epoch ``upto_epoch`` and exit.
    ``start_from`` is the chain's experiment dir, so every link resumes what
    the one before saved; the first link finds no infos there and starts
    fresh."""
    overrides = {
        "max_epochs": upto_epoch,
        "start_from": resolved_expr_dir(cfg),
        "preempt_save": True,  # the handoff between links depends on it
    }
    argv = [sys.executable, "-m", CHILD_MODULE]
    for f in dataclasses.fields(Config):
        if f.name in ("current_lr", "ss_prob"):  # derived per epoch
            continue
        value = overrides.get(f.name, getattr(cfg, f.name))
        if value is None:
            continue
        if isinstance(value, bool):
            value = "true" if value else "false"
        argv += [f"--{f.name}", str(value)]
    return argv


def _default_spawn(argv: List[str], log_path: str, timeout_s: float, grace_s: float) -> int:
    """Run one child, its output appended to ``log_path``. On a timeout, or
    an exception in the supervisor (KeyboardInterrupt, or the SystemExit
    that ``cli_entry`` raises on SIGTERM), the child gets SIGTERM, so that its
    PreemptionGuard finishes the step in flight and saves, and SIGKILL after
    ``grace_s``. Returns the child's exit code (-signal if killed)."""
    with open(log_path, "ab") as out:
        proc = subprocess.Popen(argv, stdout=out, stderr=subprocess.STDOUT)
        try:
            proc.wait(timeout=timeout_s if timeout_s > 0 else None)
        except subprocess.TimeoutExpired:
            log.warning("child exceeded %.0f s: sending SIGTERM for a clean preempt-save (%.0f s grace)",
                        timeout_s, grace_s)
            _terminate(proc, grace_s)
        except BaseException:
            _terminate(proc, grace_s)
            raise
        return proc.returncode


def _terminate(proc: subprocess.Popen, grace_s: float) -> None:
    try:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=grace_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    except ProcessLookupError:
        pass


def run_chain(
    cfg: Config,
    max_retries: int = 3,
    child_timeout_s: float = 0.0,
    term_grace_s: float = 180.0,
    spawn: Optional[Callable[[List[str], str, float, float], int]] = None,
) -> dict:
    """Drive ``cfg.max_epochs`` epochs as a chain of child processes.

    ``spawn(argv, log_path, timeout_s, grace_s) -> returncode`` runs one
    child (by default a subprocess). Returns the chain record, which is also
    written to ``<expr>/chain.json`` after every spawn.
    """
    if cfg.start_from is not None:
        raise ValueError(
            f"--start_from {cfg.start_from!r}: the chain resumes its own experiment dir "
            f"{resolved_expr_dir(cfg)!r} and cannot start from another run's; drop --start_from "
            "(to resume a chain, run the same command again)"
        )
    spawn = spawn or _default_spawn
    expr = resolved_expr_dir(cfg)
    os.makedirs(expr, exist_ok=True)
    # a restarted supervisor resumes the chain: it keeps the spawns of the
    # run before and trusts its completed_epochs
    record: dict = {"target_epochs": cfg.max_epochs, "completed_epochs": 0, "spawns": []}
    chain_path = os.path.join(expr, "chain.json")
    if os.path.exists(chain_path):
        try:
            with open(chain_path) as f:
                prior = json.load(f)
            record["spawns"] = list(prior.get("spawns", []))
            record["completed_epochs"] = int(prior.get("completed_epochs", 0))
        except (json.JSONDecodeError, OSError, ValueError):
            pass  # torn: decided from the infos below
    infos = ckpt.load_infos(expr) or {}
    if record["completed_epochs"]:
        start_epoch = record["completed_epochs"] + 1
    else:
        # infos of a finished epoch and of a mid-epoch gate look alike, so
        # the infos' epoch is run again: the child resumes it at its iter
        start_epoch = int(infos.get("epoch", 1))
        record["completed_epochs"] = start_epoch - 1
    last_total_iter = int(infos.get("total_iter", 0))

    def _write_record() -> None:
        tmp = chain_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(record, f, indent=1)
        os.replace(tmp, chain_path)

    for epoch in range(start_epoch, cfg.max_epochs + 1):
        retries = 0
        attempt = 0
        while True:
            attempt += 1
            argv = child_argv(cfg, epoch)
            log_path = os.path.join(expr, f"chain_epoch{epoch}_try{attempt}.log")
            log.info("chain: epoch %d attempt %d -> %s", epoch, attempt, log_path)
            t0 = time.perf_counter()
            rc = spawn(argv, log_path, child_timeout_s, term_grace_s)
            wall = time.perf_counter() - t0
            infos = ckpt.load_infos(expr) or {}
            total_iter = int(infos.get("total_iter", 0))
            preempted = bool(infos.get("preempted"))
            progressed = total_iter > last_total_iter
            last_total_iter = max(last_total_iter, total_iter)
            record["spawns"].append({
                "epoch": epoch, "attempt": attempt, "returncode": rc, "wall_s": round(wall, 1),
                "preempted": preempted, "total_iter": total_iter, "progressed": progressed,
            })
            _write_record()

            if rc == 0 and not preempted:
                record["completed_epochs"] = epoch
                _write_record()
                log.info("chain: epoch %d complete (%.0f s, total_iter %d)", epoch, wall, total_iter)
                break
            # preempted or crashed: respawn. Progress (watchdog handoffs on a
            # leaking host) resets the retry budget; a spin without new
            # iterations spends it.
            if progressed:
                retries = 0
            else:
                retries += 1
                if retries > max_retries:
                    raise RuntimeError(
                        f"chain: epoch {epoch} made no progress over {max_retries} consecutive respawns "
                        f"(last rc {rc}); see {log_path}"
                    )
            log.warning("chain: respawning epoch %d (rc %s, preempted=%s, progressed=%s, retries %d/%d)",
                        epoch, rc, preempted, progressed, retries, max_retries)
    return record


def _exit_on_sigterm(signum, frame):
    # raised in the main thread, where _default_spawn waits on the child: its
    # handler terminates the child before the supervisor exits
    raise SystemExit(128 + signum)


def cli_entry(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(description="epoch-chain training supervisor", add_help=False)
    ap.add_argument("--max_retries", type=int, default=3)
    ap.add_argument("--child_timeout_s", type=float, default=0.0)
    ap.add_argument("--term_grace_s", type=float, default=180.0)
    if "-h" in argv or "--help" in argv:
        # the Config parser below prints the rest
        print("supervisor flags: --max_retries N (default 3), --child_timeout_s S (0 = none), "
              "--term_grace_s S (default 180)\nall other flags pass through to cli.main (one child per epoch):\n")
    chain_ns, rest = ap.parse_known_args(argv)
    cfg = parse_config(rest)
    previous = signal.signal(signal.SIGTERM, _exit_on_sigterm)
    try:
        run_chain(cfg, max_retries=chain_ns.max_retries, child_timeout_s=chain_ns.child_timeout_s,
                  term_grace_s=chain_ns.term_grace_s)
    finally:
        signal.signal(signal.SIGTERM, previous)


if __name__ == "__main__":
    cli_entry()
