"""The card's idle share of the profiled training steps, in percent: one
minus the union of the device events' intervals over the same steps' wall
time."""


def read(run):
    if not run.events.device:
        return None
    return 100.0 * (1.0 - run.busy_s / run.wall_s)
