"""The reduction of a profile: device time attributed to the range open at
each launch, the busy union, and the idle gaps by what the host was doing."""

import pytest

from harness.trace import Profile


def X(cat, name, ts, dur, tid, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    X("user_annotation", "perfbench.window", 0, 100, 1),
    X("user_annotation", "perfbench.decode", 1, 40, 1),
    X("user_annotation", "perfbench.lstm_cell", 2, 3, 1),
    X("user_annotation", "perfbench.backward", 50, 40, 1),
    X("cuda_runtime", "cudaLaunchKernel", 3, 1, 1, corr=1),   # inside decode > lstm_cell
    X("cuda_runtime", "cudaLaunchKernel", 10, 1, 1, corr=2),  # inside decode
    X("cuda_runtime", "cudaLaunchKernel", 55, 1, 9, corr=3),  # the autograd thread: no range
    X("kernel", "cell", 4, 6, 7, corr=1),
    X("kernel", "head", 12, 8, 7, corr=2),
    X("gpu_memcpy", "copy", 60, 10, 8, corr=3),
    X("kernel", "outside", 120, 5, 7, corr=3),  # after the window: left out
]


def test_device_time_by_range_and_busy_union():
    p = Profile(EVENTS)
    assert p.window_s == pytest.approx(100e-6)
    assert p.busy_s == pytest.approx(24e-6)
    assert p.device_s_in("lstm_cell") == (pytest.approx(6e-6), 1)
    assert p.device_s_in("decode") == (pytest.approx(14e-6), 2)
    assert p.device_s_in("backward") == (0.0, 0)
    assert [n for n, _ in p.top_ops()] == ["copy", "head", "cell"]


def test_idle_gaps_by_the_host_range():
    gaps = dict(Profile(EVENTS).idle_gaps())
    # [0, 4): only the window open; [10, 12) and [20, 60) begin inside
    # decode, after its launches; [70, 100) follows the autograd thread's
    # launch, which has no range: the main thread's, backward
    assert gaps == {"outside the benchmark's ranges": pytest.approx(4e-6), "decode": pytest.approx(42e-6),
                    "backward": pytest.approx(30e-6)}
