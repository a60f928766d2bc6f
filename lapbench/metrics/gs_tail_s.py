"""gs_tail_s: seconds of the native Gauss-Seidel finisher a request (the
program's ``meta["host_gs_time"]``; a batch's total over its instances),
mean per request of the traced window."""


def read(run):
    return run.mean_meta("host_gs_time")
