"""The share of the profiled stretch in which no operation ran on the
device: 1 minus the union of the device operations' intervals over the
stretch's seconds, in percent."""


def read(run):
    if run.window_s <= 0 or run.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
