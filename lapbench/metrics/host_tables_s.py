"""host_tables_s: seconds a request spends building the host tables (the
program's span ``host_tables``: the value scan, the transform and eps
schedule, the host CSR, the CSC of the FR tail, ``bigp``; on the sharded
path also the row padding, the masked values and the FR sweeps; on the
batch path the value scalars and the batch's CSR), mean per request of
the traced window."""

from lapbench import program_spans


def read(run):
    return program_spans.mean_over_requests(
        run, lambda spans: program_spans.total_s(spans, "host_tables"))
