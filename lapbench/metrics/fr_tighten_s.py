"""fr_tighten_s: seconds of the forward-reverse sweeps that tighten a warm
start's prices (the program's span ``fr_tighten``), mean per request of
the traced window."""

from lapbench import program_spans


def read(run):
    return program_spans.mean_over_requests(
        run, lambda spans: program_spans.total_s(spans, "fr_tighten"))
