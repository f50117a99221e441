"""What a traced run records, and the reduction of a profile to numbers.

``Run`` is what every per-layer reader in ``perfbench/metrics/`` reads:
host-clock and CUDA-event timings by phase, counters of the work done, and
``Profile``, the device timeline of the traced window.

The profile comes from ``torch.profiler`` (CUPTI), exported as a Chrome
trace and read back: each device operation is matched to the runtime call
that launched it (their ``correlation``), and so to the benchmark's
``record_function`` range that was open on the launching thread. Device
time "inside" a range is the time of the operations launched inside it.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import torch

PREFIX = "perfbench."
WINDOW = PREFIX + "window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Run:
    """The readings of one run, handed to the metric readers."""

    def __init__(self, cell: str):
        self.cell = cell
        self.timers: Dict[str, List[float]] = collections.defaultdict(list)  # ms per call
        self.counters: Dict[str, float] = collections.defaultdict(float)
        self.profile: Optional["Profile"] = None
        #: seconds of the traced work run without the profiler, to a synchronise
        self.unprofiled_s: Optional[float] = None
        self._pending: List[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = []

    @contextlib.contextmanager
    def device_timer(self, name: str):
        """CUDA events around the work queued inside; read at ``settle``."""
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        try:
            yield
        finally:
            b.record()
            self._pending.append((name, a, b))

    def settle(self) -> None:
        torch.cuda.synchronize()
        for name, a, b in self._pending:
            self.timers[name].append(a.elapsed_time(b))
        self._pending.clear()


def span(name: str):
    return torch.profiler.record_function(PREFIX + name)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Profile:
    """The device timeline of one traced window (times in microseconds)."""

    def __init__(self, events: List[dict]):
        ranges: Dict[int, List[Tuple[float, float, str]]] = collections.defaultdict(list)
        launches: Dict[int, Tuple[int, float]] = {}
        self.ops: List[Tuple[str, float, float, Optional[int]]] = []
        window = None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, args = e.get("cat", ""), e.get("args") or {}
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if cat == "user_annotation" and e["name"].startswith(PREFIX):
                if e["name"] == WINDOW:
                    window = (ts, ts + dur)
                ranges[e["tid"]].append((ts, ts + dur, e["name"][len(PREFIX):]))
            elif cat in _LAUNCH_CATS and "correlation" in args:
                launches[args["correlation"]] = (e["tid"], ts)
            elif cat in _DEVICE_CATS:
                self.ops.append((e["name"], ts, ts + dur, args.get("correlation")))
        if window is None:
            raise RuntimeError("the profile holds no window range")
        self.window = window
        self._ranges = {t: sorted(r) for t, r in ranges.items()}
        by_thread: Dict[int, List[Tuple[float, int]]] = collections.defaultdict(list)
        for corr, (tid, ts) in launches.items():
            by_thread[tid].append((ts, corr))
        self._launch_seq = sorted((ts, tid) for tid, ts in launches.values())
        self.main_thread = next((t for t, rs in self._ranges.items() if any(r[2] == "window" for r in rs)), None)
        self._open: Dict[int, Tuple[str, ...]] = {}
        for tid, items in by_thread.items():
            items.sort()
            for (_, corr), names in zip(items, self._sweep(tid, [ts for ts, _ in items])):
                self._open[corr] = names
        w0, w1 = window
        self.ops = [(n, max(s, w0), min(e, w1), c) for n, s, e, c in self.ops if e > w0 and s < w1]
        self.busy = _union([(s, e) for _, s, e, _ in self.ops])

    def _sweep(self, tid: Optional[int], times: List[float]) -> List[Tuple[str, ...]]:
        """For each of the sorted ``times``, the benchmark's ranges open on
        thread ``tid`` then, outermost first (ranges of one thread nest)."""
        rs = self._ranges.get(tid, [])
        out, stack, i = [], [], 0
        for t in times:
            while i < len(rs) and rs[i][0] <= t:
                while stack and stack[-1][1] < rs[i][0]:
                    stack.pop()
                stack.append(rs[i])
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            out.append(tuple(r[2] for r in stack))
        return out

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    def device_s_in(self, name: str) -> Tuple[float, int]:
        """(seconds of device operations launched inside range ``name``,
        how many)."""
        total, n = 0.0, 0
        for _, s, e, corr in self.ops:
            if name in self._open.get(corr, ()):
                total += e - s
                n += 1
        return total / 1e6, n

    def top_ops(self, n: int = 10) -> List[List]:
        by = collections.Counter()
        for name, s, e, _ in self.ops:
            by[name[:160]] += (e - s) / 1e6
        return [[k, v] for k, v in by.most_common(n)]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle device time in the window by what the host was doing: the
        innermost benchmark range open, when the gap began, on the thread
        that launched the last device work before it, or else on the thread
        that holds the window (where the first has none: the autograd
        engine's thread, say, which runs no range of the benchmark)."""
        gaps, t = [], self.window[0]
        for s, e in self.busy + [(self.window[1], self.window[1])]:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        starts = [ts for ts, _ in self._launch_seq]
        by_tid: Dict[Optional[int], List[int]] = collections.defaultdict(list)
        for i, (s, _) in enumerate(gaps):
            j = bisect.bisect_left(starts, s) - 1
            by_tid[self._launch_seq[j][1] if j >= 0 else self.main_thread].append(i)
        label = ["outside the benchmark's ranges"] * len(gaps)
        for tid, idx in by_tid.items():
            for thread in (tid, self.main_thread):
                for i, names in zip(idx, self._sweep(thread, [gaps[i][0] for i in idx])):
                    names = [r for r in names if r != "window"]
                    if names and label[i] == "outside the benchmark's ranges":
                        label[i] = names[-1]
        by = collections.Counter()
        for (s, e), name in zip(gaps, label):
            by[name] += (e - s) / 1e6
        return [[k, v] for k, v in by.most_common(n)]


def profile_window(fn: Callable[[], None]) -> Profile:
    """Trace one call of ``fn`` (which ends in a synchronise) on the CPU and
    the device, and read the trace back."""
    from torch.profiler import ProfilerActivity, profile

    kw = {}
    try:  # the autograd engine's device threads as well as this one (torch >= 2.7)
        from torch._C._profiler import _ExperimentalConfig

        kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        pass
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **kw) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    return Profile(events)
