"""unspanned_s: seconds of the program's root ``solve`` span that no other
span on the calling thread covers (what the program's spans leave
unnamed), mean per request of the traced window."""

from lapbench import program_spans


def read(run):
    return program_spans.mean_over_requests(
        run, lambda spans: program_spans.unspanned_s(spans))
