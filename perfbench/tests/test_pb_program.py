"""The program's spans in a profile (``harness.program``): read beside the
benchmark's ranges without moving what ``Profile`` reads, and the six
numbers on hand-computed events."""

import pytest
from test_pb_trace import EVENTS, X

from harness import program
from harness.trace import Profile

P = "show_and_tell."
SPANS = [  # on the window's thread (1), inside test_pb_trace's benchmark ranges
    X("user_annotation", P + "trunk", 0, 1, 1),
    X("user_annotation", P + "trunk.copy", 0, 0.5, 1),
    X("user_annotation", P + "decode", 1, 40, 1),
    X("user_annotation", P + "decode.step", 2, 7, 1),
    X("user_annotation", P + "op.lstm_cell", 2.5, 2.5, 1),
    X("user_annotation", P + "decode.select", 9.5, 1, 1),
    X("user_annotation", P + "decode.sync", 11, 19, 1),
    X("user_annotation", P + "train.step", 50, 45, 1),
    X("user_annotation", P + "train.backward", 52, 22, 1),
    X("user_annotation", P + "train.apply", 74, 21, 1),
    X("user_annotation", P + "train.apply.sync", 77, 18, 1),
]
ADAM = [X("cuda_runtime", "cudaLaunchKernel", 75, 1, 1, corr=4), X("kernel", "adam", 76, 2, 7, corr=4)]


def test_program_ranges_leave_the_profile_as_it_was():
    before, after = Profile(EVENTS), Profile(EVENTS[:3] + SPANS + EVENTS[3:])
    assert (after.window_s, after.busy_s) == (before.window_s, before.busy_s)
    for name in ("window", "decode", "lstm_cell", "backward"):
        assert after.device_s_in(name) == before.device_s_in(name)
    assert after.top_ops() == before.top_ops()
    assert after.idle_gaps() == before.idle_gaps()


@pytest.fixture
def spans():
    events = EVENTS + SPANS + ADAM
    return program.Spans(events, Profile(events))


def test_idle_gaps_by_program_span(spans):
    # [0, 4) begins in trunk.copy; [10, 12) in decode.select; [20, 60) in
    # decode.sync; [70, 76) follows the autograd thread's launch at 55, which
    # has no span: the window's thread's, train.backward; [78, 100) follows
    # the launch at 75, inside train.apply.sync
    assert spans.idle_by_span() == {
        "trunk.copy": pytest.approx(4e-6), "decode.select": pytest.approx(2e-6),
        "decode.sync": pytest.approx(40e-6), "train.backward": pytest.approx(6e-6),
        "train.apply.sync": pytest.approx(22e-6)}
    assert spans.idle_s({"train.apply"}) == pytest.approx(22e-6)  # its sync included
    assert spans.device_s_by_span() == {
        "op.lstm_cell": (pytest.approx(6e-6), 1), "decode.select": (pytest.approx(8e-6), 1),
        "train.backward": (pytest.approx(10e-6), 1), "train.apply": (pytest.approx(2e-6), 1)}


def test_the_six_numbers(spans):
    counters = {"program.decode.row_steps": 30, "program.decode.live_row_steps": 12}
    got = {name: read(spans, counters) for name, read in program.METRICS.items()}
    assert got == {
        "decode_launch_idle.serve": pytest.approx(2.0), "decode_sync_idle.serve": pytest.approx(40.0),
        "trunk_copy_idle.serve": pytest.approx(4.0), "decode_live_rows.serve": pytest.approx(40.0),
        "apply_idle.train": pytest.approx(22.0),
        # the copy launched by the autograd thread while the window's thread was in backward
        "backward_ops.train": 1.0,
    }
    assert sum(got[k] for k in ("decode_launch_idle.serve", "decode_sync_idle.serve",
                                "trunk_copy_idle.serve", "apply_idle.train")) <= 100 * (1 - spans.profile.busy_s
                                                                                      / spans.profile.window_s)


def test_a_program_without_spans_reads_nothing():
    spans = program.Spans(EVENTS, Profile(EVENTS))
    assert all(read(spans, {}) is None for read in program.METRICS.values())
