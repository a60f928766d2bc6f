"""hk_s: seconds of the Hopcroft-Karp pre-check a request (the program's
span ``hk``, around ``feasibility.is_feasible``), mean per request of the
traced window."""

from lapbench import program_spans


def read(run):
    return program_spans.mean_over_requests(
        run, lambda spans: program_spans.total_s(spans, "hk"))
