"""Preemption-safe training: convert SIGTERM/SIGINT into a clean save.

Cluster schedulers preempt with a SIGTERM and a short grace window before
SIGKILL. The reference has no story for this — an
interrupted train.py loses everything since its last periodic checkpoint.
Here a :class:`PreemptionGuard` turns the signal into a flag; the Trainer
checks it after every step, finishes the in-flight device work, persists
the FULL train state (params + Adam moments + step — the same artifact the
periodic checkpoint writes, ckpt/checkpoint.py) plus the resume infos, and
returns. Restarting with ``--start_from`` then continues bit for bit on the
CPU (pinned by tests/test_torch_port_trainer.py).

The guard is a context manager so the previous handlers are always
restored; outside the main thread (where CPython forbids ``signal.signal``)
it degrades to the programmatic ``trigger()`` path, which external
schedulers or tests can call directly.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Optional

log = logging.getLogger(__name__)


class PreemptionGuard:
    """Latches termination signals; query with ``triggered``."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self._event = threading.Event()
        self._prev: dict = {}
        self._installed = False

    # -- signal plumbing ------------------------------------------------

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is threading.main_thread():
            for s in self.SIGNALS:
                self._prev[s] = signal.signal(s, self._handler)
            self._installed = True
        else:  # signal.signal is main-thread-only; trigger() still works
            log.debug("PreemptionGuard outside main thread: signals not hooked")
        return self

    def __exit__(self, *exc) -> None:
        if self._installed:
            for s, prev in self._prev.items():
                signal.signal(s, prev)
            self._prev.clear()
            self._installed = False

    def _handler(self, signum, frame) -> None:
        # Latch FIRST: logging from a signal handler can raise a reentrant-
        # call RuntimeError if the signal lands while the main thread is
        # mid-write in a (locked, buffered) logging stream — the event must
        # already be set when that happens or the clean save never runs
        # (review fix). The log call itself is best-effort for the same
        # reason.
        self._event.set()
        try:
            log.warning(
                "received %s: finishing the in-flight step, then saving "
                "train state for resume", signal.Signals(signum).name,
            )
        except RuntimeError:
            pass  # reentrant stream write: the latch is what matters
        # One latch only: restore the previous handlers so a SECOND signal
        # behaves normally (KeyboardInterrupt / default termination). The
        # flag is polled between steps — if the process is hung anywhere
        # else (data loader, wedged device call), a repeat Ctrl+C must
        # still be able to kill it rather than requiring SIGKILL.
        if self._installed:
            for s, prev in self._prev.items():
                signal.signal(s, prev)
            self._prev.clear()
            self._installed = False

    # -- API ------------------------------------------------------------

    def trigger(self) -> None:
        """Programmatic preemption (tests, cluster-notice watchers)."""
        self._event.set()

    @property
    def triggered(self) -> bool:
        return self._event.is_set()


def current_rss_gb() -> float:
    """This process's CURRENT resident set size in GB (``/proc/self/statm``
    resident pages x page size). ``resource.getrusage`` reports the
    high-water mark, which never comes back down and would keep a watchdog
    latched after a transient spike; a leak detector needs the live value
    (on a monotone leak the two coincide, but the contract here is
    current)."""
    try:
        with open("/proc/self/statm") as f:
            resident_pages = int(f.read().split()[1])
        return resident_pages * _PAGE_SIZE / 1e9
    except (OSError, IndexError, ValueError):  # non-Linux fallback
        import resource
        import sys

        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # ru_maxrss units differ by platform: kilobytes on Linux, BYTES on
        # macOS/BSD — dividing bytes by 1e6 would over-report 1000x and
        # fire the watchdog instantly (review fix). High-water, not
        # current, on this path — documented best-effort.
        return peak / (1e9 if sys.platform == "darwin" else 1e6)


_PAGE_SIZE = 4096
try:
    import os as _os

    _PAGE_SIZE = _os.sysconf("SC_PAGE_SIZE")
except (ValueError, OSError, AttributeError):
    pass


class RssWatchdog:
    """Background thread that converts a host-memory leak into a clean,
    checkpointed preemption instead of an OOM kill.

    Polls :func:`current_rss_gb` every ``interval_s``; once it crosses
    ``threshold_gb`` it calls ``guard.trigger()`` — the Trainer's normal
    preemption path (finish the in-flight step, persist the full train
    state + infos, return) — and stops. With the watchdog armed, a host
    memory leak ends a long run in a resumable handoff (restart with
    ``--start_from``) rather than an OOM kill mid-step. Context manager;
    ``fired`` tells the caller whether the preemption it observed came from
    memory pressure.
    """

    def __init__(
        self,
        guard: "PreemptionGuard",
        threshold_gb: float,
        interval_s: float = 10.0,
    ):
        if threshold_gb <= 0:
            raise ValueError(f"threshold_gb must be > 0, got {threshold_gb}")
        self.guard = guard
        self.threshold_gb = float(threshold_gb)
        self.interval_s = float(interval_s)
        self.fired = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def __enter__(self) -> "RssWatchdog":
        self._thread = threading.Thread(
            target=self._run, name="rss-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 5)

    def _run(self) -> None:
        while True:
            # check BEFORE the first sleep: a process already over the
            # threshold (or a short test run) must preempt immediately
            rss = current_rss_gb()
            if rss >= self.threshold_gb:
                self.fired = True
                log.warning(
                    "host RSS %.1f GB crossed the %.1f GB watchdog "
                    "threshold: triggering clean preemption (train state "
                    "will be saved; resume with start_from / the epoch "
                    "chain supervisor)", rss, self.threshold_gb,
                )
                self.guard.trigger()
                return
            if self._stop.wait(self.interval_s):
                return
