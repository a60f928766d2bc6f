"""instances_per_s: LAP instances solved per second: the instances of the
requests completed in the window over the window, host clock."""


def read(run):
    return run.requests * run.instances / run.elapsed_s \
        if run.requests else None
