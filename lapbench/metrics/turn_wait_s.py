"""turn_wait_s: seconds a shard waits for its turn among the shard threads
(the program's counter ``turn_wait_s`` of each ``shard_pass``: time
blocked in ``ThreadGroup.wait_turn``), mean over the shards, mean per
request of the traced window."""

from lapbench import program_spans


def read(run):
    return program_spans.mean_over_requests(
        run, lambda spans: program_spans.shard_mean(spans, "turn_wait_s"))
