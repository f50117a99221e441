"""The beam attention's share of its roofline while serving: the least time
of every ``attention_beam`` call in the traced window, from its shapes
(``harness.bounds.attention_bound``), over the device time of the
operations launched inside those calls."""


def read(run):
    if run.profile is None or not run.counters.get("attention_beam_calls"):
        return None
    device_s, n = run.profile.device_s_in("attention_beam")
    if n == 0 or device_s <= 0:
        return None
    return 100.0 * run.counters["attention_beam_bound_s"] / device_s
