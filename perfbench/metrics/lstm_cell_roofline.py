"""The LSTM cell's share of its roofline while serving: the least time of
every ``ops.lstm.lstm_cell`` call in the traced window, from its shapes
(``harness.bounds.cell_bound``), over the device time of the operations
launched inside those calls."""


def read(run):
    if run.profile is None or not run.counters.get("lstm_cell_calls"):
        return None
    device_s, n = run.profile.device_s_in("lstm_cell")
    if n == 0 or device_s <= 0:
        return None
    return 100.0 * run.counters["lstm_cell_bound_s"] / device_s
