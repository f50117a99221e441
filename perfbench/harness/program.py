"""The program's own spans in a profiled window, and the six per-layer
numbers that put each idle gap down to the host phase that caused it.

Inside its ``recording()`` (``show_and_tell_tpu_torch.obs.profiler``) the
program opens ``show_and_tell.<name>`` ranges where its work happens: per
call and chunk, the trunk's copy, transform and backbone, each decode step,
selection and ``finished.all()`` read, the strings, the kernels' entry
points, and the training step's phases. They are ``record_function``
ranges, so they sit in the profile beside the benchmark's ``perfbench.*``
ranges, which ``harness.trace.Profile`` reads and this module leaves alone,
on the device's clock. ``Spans`` reads them from the same events by
``Profile``'s rules:

- an idle gap goes to the program spans open when it began on the thread
  that launched the last device work before it, or else, where that thread
  had none open (the autograd engine's), on the window's thread;
- a device operation goes to the spans open at its launch on the launching
  thread, or else on the window's thread.

``METRICS`` defines the six numbers from a ``Spans`` and the recording's
counters. No cell reads them yet: that needs the profiled passes run inside
the program's recording and their events kept (``PERF.md`` §7).
"""

from __future__ import annotations

import bisect
import collections
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from harness.trace import _LAUNCH_CATS, Profile

PROGRAM = "show_and_tell."
OUTSIDE = "outside the program's spans"


class Spans:
    """The program's ranges of one profiled window, over ``profile``, the
    ``Profile`` of the same ``events``."""

    def __init__(self, events: List[dict], profile: Profile):
        self.profile = profile
        ranges: Dict[int, List[Tuple[float, float, str]]] = collections.defaultdict(list)
        self._launches: Dict[int, Tuple[int, float]] = {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, args = e.get("cat", ""), e.get("args") or {}
            if cat == "user_annotation" and e["name"].startswith(PROGRAM):
                ts = float(e["ts"])
                ranges[e["tid"]].append((ts, ts + float(e.get("dur", 0.0)), e["name"][len(PROGRAM):]))
            elif cat in _LAUNCH_CATS and "correlation" in args:
                self._launches[args["correlation"]] = (e["tid"], float(e["ts"]))
        self.ranges = {t: sorted(r, key=lambda r: (r[0], -r[1])) for t, r in ranges.items()}
        self._gaps: Optional[List[Tuple[float, float, Tuple[str, ...]]]] = None

    def _open(self, tid, times: List[float]) -> List[Tuple[str, ...]]:
        """The program spans open on thread ``tid`` at each of the sorted
        ``times``, outermost first (one thread's spans nest; a span that
        ends where the next begins is closed by it)."""
        rs = self.ranges.get(tid, [])
        out, stack, i = [], [], 0
        for t in times:
            while i < len(rs) and rs[i][0] <= t:
                while stack and stack[-1][1] <= rs[i][0]:
                    stack.pop()
                stack.append(rs[i])
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            out.append(tuple(r[2] for r in stack))
        return out

    def _either(self, tid, times: List[float]) -> List[Tuple[str, ...]]:
        """The spans open on ``tid``, or where it has none on the window's
        thread, at each of the sorted ``times``."""
        own, main = self._open(tid, times), self._open(self.profile.main_thread, times)
        return [o or m for o, m in zip(own, main)]

    def count(self, name: str) -> int:
        """How many ranges named ``name`` the window's thread opened in the
        window."""
        w0, w1 = self.profile.window
        return sum(1 for s, e, n in self.ranges.get(self.profile.main_thread, ()) if n == name and w0 <= s < w1)

    def gaps(self) -> List[Tuple[float, float, Tuple[str, ...]]]:
        """Each idle gap of the window: (start, seconds, the program spans
        open when it began, outermost first)."""
        if self._gaps is None:
            p = self.profile
            gaps, t = [], p.window[0]
            for s, e in p.busy + [(p.window[1], p.window[1])]:
                if s > t:
                    gaps.append((t, s))
                t = max(t, e)
            starts = [ts for ts, _ in p._launch_seq]
            by_tid: Dict[Optional[int], List[int]] = collections.defaultdict(list)
            for i, (s, _) in enumerate(gaps):
                j = bisect.bisect_left(starts, s) - 1
                by_tid[p._launch_seq[j][1] if j >= 0 else p.main_thread].append(i)
            open_at: List[Tuple[str, ...]] = [()] * len(gaps)
            for tid, idx in by_tid.items():
                for i, names in zip(idx, self._either(tid, [gaps[i][0] for i in idx])):
                    open_at[i] = names
            self._gaps = [(s, (e - s) / 1e6, names) for (s, e), names in zip(gaps, open_at)]
        return self._gaps

    def idle_s(self, names: Iterable[str]) -> float:
        """Idle seconds in the gaps that began inside any span of ``names``
        (its children included)."""
        names = set(names)
        return sum(sec for _, sec, open_ in self.gaps() if names.intersection(open_))

    def idle_by_span(self) -> Dict[str, float]:
        """Idle seconds by the innermost program span open when each gap
        began."""
        by: Dict[str, float] = collections.Counter()
        for _, sec, open_ in self.gaps():
            by[open_[-1] if open_ else OUTSIDE] += sec
        return dict(by)

    def at_launch(self) -> Dict[int, Tuple[str, ...]]:
        """For the correlation id of each device operation in the window,
        the program spans open at its launch (outermost first)."""
        by_tid: Dict[int, List[Tuple[float, int]]] = collections.defaultdict(list)
        for _, _, _, corr in self.profile.ops:
            if corr in self._launches:
                tid, ts = self._launches[corr]
                by_tid[tid].append((ts, corr))
        out = {}
        for tid, items in by_tid.items():
            items.sort()
            for (_, corr), names in zip(items, self._either(tid, [ts for ts, _ in items])):
                out[corr] = names
        return out

    def device_s_by_span(self) -> Dict[str, Tuple[float, int]]:
        """(device seconds, operations) by the innermost program span open at
        each operation's launch."""
        opened = self.at_launch()
        by: Dict[str, List] = collections.defaultdict(lambda: [0.0, 0])
        for _, s, e, corr in self.profile.ops:
            names = opened.get(corr, ())
            acc = by[names[-1] if names else OUTSIDE]
            acc[0] += (e - s) / 1e6
            acc[1] += 1
        return {k: (v[0], v[1]) for k, v in by.items()}

    def ops_launched_in(self, name: str) -> int:
        """Device operations of the window launched, on any thread, while
        the window's thread was inside span ``name``."""
        items = sorted((self._launches[corr][1], corr) for _, _, _, corr in self.profile.ops
                       if corr in self._launches)
        main = self._open(self.profile.main_thread, [ts for ts, _ in items])
        return sum(1 for names in main if name in names)


def _share(names: Iterable[str]) -> Callable:
    def read(spans: Spans, counters) -> Optional[float]:
        if not spans.ranges or spans.profile.window_s <= 0:
            return None
        return 100.0 * spans.idle_s(names) / spans.profile.window_s

    return read


def _live_rows(spans: Spans, counters) -> Optional[float]:
    rows = counters.get("program.decode.row_steps")
    return 100.0 * counters.get("program.decode.live_row_steps", 0) / rows if rows else None


def _backward_ops(spans: Spans, counters) -> Optional[float]:
    steps = spans.count("train.step")
    return spans.ops_launched_in("train.backward") / steps if steps else None


#: each metric's reading from the window's ``Spans`` and the recording's
#: counters (under ``program.`` keys); None where the window has none of it
METRICS: Dict[str, Callable] = {
    "decode_launch_idle.serve": _share({"decode.step", "decode.select", "decode.prepare"}),
    "decode_sync_idle.serve": _share({"decode.sync"}),
    "trunk_copy_idle.serve": _share({"trunk.copy"}),
    "decode_live_rows.serve": _live_rows,
    "apply_idle.train": _share({"train.apply"}),
    "backward_ops.train": _backward_ops,
}
