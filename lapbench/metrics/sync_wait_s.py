"""sync_wait_s: seconds a shard waits in its host reads of device values
(the program's counter ``sync_wait_s`` of each ``shard_pass``: the active
counts and the exchange counts read back each round), mean over the
shards, mean per request of the traced window."""

from lapbench import program_spans


def read(run):
    return program_spans.mean_over_requests(
        run, lambda spans: program_spans.shard_mean(spans, "sync_wait_s"))
