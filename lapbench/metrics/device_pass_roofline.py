"""device_pass_roofline: the least time the device pass could take over
the time its kernels took.  Least time: the bytes the pass must move for
these inputs (``yardstick.pass_bytes``: each input byte read once, each
output byte written once, per instance) at the card's published HBM
bandwidth.  Kernel time: the summed duration of every kernel in the
traced window (copies left out), per request."""

from lapbench import yardstick


def read(run):
    t = run.trace
    if not t or not run.requests or t["kernel_s_total"] <= 0:
        return None
    nbytes = sum(yardstick.pass_bytes(run.n, run.m, nnz, run.instances)
                 for nnz in run.nnz_per_request)
    least = nbytes / yardstick.hbm_bytes_per_s(run.kind)
    return 100.0 * least / t["kernel_s_total"]
