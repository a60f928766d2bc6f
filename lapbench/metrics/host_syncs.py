"""host_syncs: host reads of device values a shard makes (the program's
counter ``host_syncs`` of each ``shard_pass``), mean over the shards,
mean per request of the traced window."""

from lapbench import program_spans


def read(run):
    return program_spans.mean_over_requests(
        run, lambda spans: program_spans.shard_mean(spans, "host_syncs"))
