"""Share of the traced sub-window in which no operation ran on the
device: 1 - (union of the trace's device intervals) / (the sub-window's
wall). Moves ``recon_per_s``."""


def read(run):
    if not run.window_s or run.busy_s is None or run.busy_s <= 0:
        return None
    return 1.0 - run.busy_s / run.window_s
