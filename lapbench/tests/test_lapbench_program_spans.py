"""The readers of the program's spans and counters
(``lapbench/program_spans.py`` and the metrics that use it) on a
synthetic run and recorder buffer: each reader's number, None without a
recorder or from a buffer that has wrapped past the window's start, and
a traced CPU run of each cell that reports every such metric it lists."""

import types

import pytest

from lapbench import harness, program_spans
from lapbench.tests.test_lapbench_run import _run

READERS = ("hk_s", "host_tables_s", "fr_tighten_s", "objective_s",
           "device_setup_s", "unspanned_s", "turn_wait_s", "sync_wait_s",
           "host_syncs", "queue_wait_s")


def _rec(name, i, parent, root, t0, t1, thread=1, rank=None, **counts):
    return {"name": name, "id": i, "parent": parent, "root": root,
            "thread": thread, "rank": rank, "t0": t0, "t1": t1,
            "counts": counts}


def _request(base, t):
    """One request's spans, ids from ``base``, starting at ``t``: a root
    of 10 s; on its thread hk 1, host_tables 1.5 (fr_tighten 0.5 inside),
    device_pass 3 (device_setup 0.25 inside), queue_wait 0.5, gs_tail 1,
    objective 0.5, leaving 2.5 s uncovered; two shard threads."""
    r = base
    return [
        _rec("hk", r + 1, r, r, t + 1, t + 2),
        _rec("fr_tighten", r + 3, r + 2, r, t + 2.5, t + 3),
        _rec("host_tables", r + 2, r, r, t + 2, t + 3.5),
        _rec("device_setup", r + 5, r + 4, r, t + 4, t + 4.25),
        _rec("shard_pass", r + 6, r + 4, r, t + 4, t + 6.9, thread=7,
             rank=0, turn_wait_s=2.0, sync_wait_s=0.5, host_syncs=10),
        _rec("shard_pass", r + 7, r + 4, r, t + 4, t + 6.9, thread=8,
             rank=1, turn_wait_s=1.0, sync_wait_s=0.25, host_syncs=20),
        _rec("device_setup", r + 8, r + 7, r, t + 4, t + 4.5, thread=8,
             rank=1),
        _rec("device_pass", r + 4, r, r, t + 4, t + 7),
        _rec("queue_wait", r + 9, r, r, t + 7, t + 7.5),
        _rec("gs_tail", r + 10, r, r, t + 7.5, t + 8.5),
        _rec("objective", r + 11, r, r, t + 8.5, t + 9),
        _rec("solve", r, None, r, t, t + 10),
    ]


def _fake(recs, max_spans=65536):
    return types.SimpleNamespace(spans=lambda: list(recs),
                                 MAX_SPANS=max_spans)


def _run_of(*windows):
    spans = [{"name": "solve", "req": -1, "t0": 0.0, "t1": 20.0}]
    spans += [{"name": "solve", "req": k, "t0": t0, "t1": t1}
              for k, (t0, t1) in enumerate(windows)]
    return harness.Run(spans=spans, records=[])


# request 0 at t = 100, request 1 at t = 200; the warm-up's root at t = 5
BUFFER = _request(1, 5) + _request(101, 100) + _request(201, 200)
RUN = _run_of((99.0, 111.0), (199.0, 211.0))
EXPECT = {"hk_s": 1.0, "host_tables_s": 1.5, "fr_tighten_s": 0.5,
          "objective_s": 0.5, "device_setup_s": 0.75,
          "unspanned_s": 2.5, "turn_wait_s": 1.5,
          "sync_wait_s": 0.375, "host_syncs": 15.0, "queue_wait_s": 0.5}


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_the_window_requests(monkeypatch, name):
    monkeypatch.setattr(program_spans, "_recorder", lambda: _fake(BUFFER))
    assert harness.reader(name)(RUN) == pytest.approx(EXPECT[name])


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_a_recorder(monkeypatch, name):
    monkeypatch.setattr(program_spans, "_recorder", lambda: None)
    assert harness.reader(name)(RUN) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_from_a_wrapped_buffer(monkeypatch, name):
    # full, and its oldest span closed after the window began
    window = _request(101, 100) + _request(201, 200)
    monkeypatch.setattr(program_spans, "_recorder",
                        lambda: _fake(window, max_spans=len(window)))
    assert harness.reader(name)(RUN) is None
    # full, but a span from before the window is still there: nothing of
    # the window was dropped
    monkeypatch.setattr(program_spans, "_recorder",
                        lambda: _fake(BUFFER, max_spans=len(BUFFER)))
    assert harness.reader(name)(RUN) == pytest.approx(EXPECT[name])


def test_the_recorder_is_found_or_missed_by_its_spans(monkeypatch):
    from sslap_tpu_torch.utils import profiling
    assert program_spans._recorder() is profiling
    monkeypatch.delattr(profiling, "spans")
    assert program_spans._recorder() is None
    assert program_spans.requests(RUN) is None


def test_unspanned_counts_only_the_roots_thread_and_cuts_to_the_root():
    spans = [_rec("solve", 1, None, 1, 0.0, 10.0),
             _rec("a", 2, 1, 1, -1.0, 2.0), _rec("b", 3, 1, 1, 1.0, 3.0),
             _rec("c", 4, 1, 1, 9.0, 12.0),
             _rec("shard_pass", 5, 1, 1, 3.0, 9.0, thread=2)]
    assert program_spans.unspanned_s(spans) == pytest.approx(6.0)


@pytest.mark.parametrize("cell", ["sparse1M.cold", "sparse1M.track",
                                  "batch256.cold", "rowpart1M.4card"])
def test_a_traced_cpu_run_reports_every_program_metric(cell):
    r = _run(cell, trace=True)
    assert r["correct"] is True
    for m in harness.load_cell(cell)["per_layer"]:
        if m["name"].split(".")[0] in READERS:
            assert r["metrics"][m["name"]]["value"] >= 0, m["name"]
