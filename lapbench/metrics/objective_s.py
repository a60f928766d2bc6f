"""objective_s: seconds computing the reported objectives from the input
costs (the program's span ``objective``), mean per request of the traced
window."""

from lapbench import program_spans


def read(run):
    return program_spans.mean_over_requests(
        run, lambda spans: program_spans.total_s(spans, "objective"))
