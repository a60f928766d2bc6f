"""device_setup_s: seconds of the device pass's host set-up before its
first launch (the program's span ``device_setup``: the uploads, the
masked values, the wide-layout guard and the tiers; a shard's uploads; a
dense chunk's block), summed over the shards or chunks, mean per request
of the traced window.  Inside ``device_pass_s``."""

from lapbench import program_spans


def read(run):
    return program_spans.mean_over_requests(
        run, lambda spans: program_spans.total_s(spans, "device_setup"))
