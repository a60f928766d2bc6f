"""idle_pct: share of the traced window in which no kernel and no copy
ran on the device (the union of the profiler's device intervals), the
mean over the cell's cards."""


def read(run):
    return run.trace["idle_pct"] if run.trace else None
