"""Share of the traced window in which no operation ran on the device: the
union of the device operations' intervals in the profile, against the
window's length."""


def read(run):
    if run.profile is None or run.profile.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.profile.busy_s / run.profile.window_s)
