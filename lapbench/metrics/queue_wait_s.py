"""queue_wait_s: seconds the calling thread of the dense batch waits for
the worker's next chunk (the program's spans ``queue_wait``, summed),
mean per request of the traced window."""

from lapbench import program_spans


def read(run):
    return program_spans.mean_over_requests(
        run, lambda spans: program_spans.total_s(spans, "queue_wait"))
