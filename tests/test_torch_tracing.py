"""The port's span-and-counter recorder (sslap_tpu_torch.utils.profiling)
on the CPU: the spans each public entry records (the square hybrid, a
warm FR solve, the sharded hybrid on meshes of 2 and 4 threads, the dense
batch with its worker thread), their agreement with the meta timers,
their ranges in a profiler's Chrome trace from every thread, and the
recorder itself (no profiler range without a profiler, the bounded
buffer, counters on the root, a parent handed to another thread)."""

import glob
import json
import threading

import numpy as np
import pytest
import torch

import sslap_tpu_torch as P
from sslap_tpu_torch import parallel as PP
from sslap_tpu_torch.batch import auction_solve_batched, stack_problems
from sslap_tpu_torch.utils import profiling as prof
from tests.utils import random_sparse_instance

CPU = torch.device("cpu")
N = 300
HYBRID_CHILDREN = {"hk", "host_tables", "device_pass", "device_setup",
                   "readback", "gs_tail", "objective"}


def _instance(n=N, seed=3):
    rng = np.random.default_rng(seed)
    loc, val, _ = random_sparse_instance(rng, n, n, 0.03, integer=False)
    return loc, val.astype(np.float32)


@pytest.fixture(autouse=True)
def _fresh_buffer():
    prof.clear()
    yield
    prof.clear()


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r["name"], []).append(r)
    return out


def _solve(**kw):
    loc, val = _instance()
    solve_kw = kw.pop("solve", {})
    s = P.AuctionSolver(loc=loc, val=val, shape=(N, N), device="cpu", **kw)
    return s, s.solve(**solve_kw)


def test_hybrid_solve_records_the_root_and_its_children():
    _, res = _solve(mode="hybrid")
    assert res["meta"]["soln_found"]
    recs = prof.spans()
    names = _by_name(recs)
    assert set(names) == {"solve", "csc"} | HYBRID_CHILDREN
    (root,) = names["solve"]
    assert root["parent"] is None and root["root"] == root["id"]
    for r in recs:
        assert r["root"] == root["id"]
        assert r["thread"] == root["thread"]
        assert root["t0"] <= r["t0"] <= r["t1"] <= root["t1"]
    assert names["device_setup"][0]["parent"] == \
        names["device_pass"][0]["id"]
    # the FR tail's CSC is built inside host_tables
    assert names["csc"][0]["parent"] == names["host_tables"][0]["id"]
    # the root's children on the calling thread do not overlap
    kids = sorted((r["t0"], r["t1"]) for r in recs
                  if r["parent"] == root["id"])
    assert all(a[1] <= b[0] for a, b in zip(kids, kids[1:]))


def test_spans_equal_the_meta_timers():
    _, res = _solve(mode="hybrid")
    meta, names = res["meta"], _by_name(prof.spans())
    for span, key in (("device_pass", "device_time"),
                      ("readback", "readback_time"),
                      ("gs_tail", "host_gs_time")):
        (r,) = names[span]
        assert abs((r["t1"] - r["t0"]) - meta[key]) < 1e-3


def test_warm_fr_solve_has_fr_tighten_and_no_hk_without_the_check():
    _, cold = _solve(mode="hybrid")
    prof.clear()
    _, warm = _solve(mode="hybrid", cardinality_check=False,
                     solve=dict(warm_prices=cold["prices"], warm_mode="fr"))
    assert warm["meta"]["soln_found"]
    names = _by_name(prof.spans())
    assert "fr_tighten" in names and "hk" not in names
    assert names["fr_tighten"][0]["parent"] == names["solve"][0]["id"]


def test_a_second_solve_on_cached_tables_records_a_new_root():
    s, _ = _solve(mode="hybrid")
    first = _by_name(prof.spans())["solve"][0]
    prof.clear()
    res = s.solve()         # tables, the CSC too, from the solver's cache
    assert res["meta"]["soln_found"]
    recs = prof.spans()
    names = _by_name(recs)
    assert set(names) == {"solve"} | HYBRID_CHILDREN
    (root,) = names["solve"]
    assert root["id"] > first["id"]
    assert all(r["root"] == root["id"] for r in recs)


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_hybrid_records_one_shard_pass_a_rank(shards):
    loc, val = _instance()
    res = PP.auction_solve_sharded_hybrid(
        loc=loc, val=val, shape=(N, N), mesh=PP.make_mesh([CPU] * shards))
    assert res["meta"]["soln_found"]
    recs = prof.spans()
    names = _by_name(recs)
    (root,) = names["solve"]
    (dp,) = names["device_pass"]
    assert abs((dp["t1"] - dp["t0"]) - res["meta"]["device_time"]) < 1e-3
    passes = names["shard_pass"]
    assert sorted(r["rank"] for r in passes) == list(range(shards))
    assert len({r["thread"] for r in passes}) == shards
    assert root["thread"] not in {r["thread"] for r in passes}
    for r in passes:
        assert r["parent"] == dp["id"] and r["root"] == root["id"]
        c = r["counts"]
        assert set(c) == {"turn_wait_s", "sync_wait_s", "host_syncs"}
        assert c["turn_wait_s"] + c["sync_wait_s"] <= r["t1"] - r["t0"]
        assert c["host_syncs"] > 0
    setups = names["device_setup"]
    assert sorted(r["rank"] for r in setups) == list(range(shards))


def test_solver_entry_opens_one_root_over_the_sharded_entry():
    _, res = _solve(mode="sharded_hybrid")
    assert res["meta"]["soln_found"]
    names = _by_name(prof.spans())
    assert len(names["solve"]) == 1
    assert {"hk", "host_tables", "device_pass", "shard_pass", "gs_tail",
            "objective"} <= set(names)


def test_dense_batch_records_the_worker_under_the_root():
    loc, val = _instance(n=64, seed=5)
    batch = stack_problems([P.from_coo(loc, val, shape=(64, 64))] * 3)
    _, metas = auction_solve_batched(batch, mode="hybrid", device="cpu",
                                     chunk=2)
    assert all(mt["soln_found"] for mt in metas)
    recs = prof.spans()
    names = _by_name(recs)
    (root,) = names["solve"]
    assert all(r["root"] == root["id"] for r in recs)
    passes, waits = names["chunk_pass"], names["queue_wait"]
    assert len(passes) == 2 and len(waits) == 2
    assert len(names["gs_tail"]) == 2 and len(names["device_setup"]) == 2
    assert {r["thread"] for r in passes} != {root["thread"]}
    assert all(r["thread"] == root["thread"] for r in waits)
    assert abs(sum(r["t1"] - r["t0"] for r in passes)
               - metas[0]["device_time"]) < 1e-3
    assert abs(sum(r["t1"] - r["t0"] for r in names["gs_tail"])
               - metas[0]["host_gs_time"]) < 1e-3


def test_profile_trace_holds_ranges_from_every_thread(tmp_path):
    loc, val = _instance()
    with prof.profile_trace(str(tmp_path)):
        PP.auction_solve_sharded_hybrid(
            loc=loc, val=val, shape=(N, N), mesh=PP.make_mesh([CPU] * 4))
        batch = stack_problems(
            [P.from_coo(*_instance(64, 5), shape=(64, 64))] * 2)
        auction_solve_batched(batch, mode="hybrid", device="cpu", chunk=1)
    (path,) = glob.glob(str(tmp_path / "trace_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    tids = {}
    for e in events:
        if str(e.get("name", "")).startswith("sslap/"):
            tids.setdefault(e["name"], set()).add(e["tid"])
    main = tids["sslap/solve"]
    assert len(main) == 1
    assert len(tids["sslap/shard_pass"]) == 4
    assert not tids["sslap/shard_pass"] & main
    assert tids["sslap/chunk_pass"] and not tids["sslap/chunk_pass"] & main
    assert tids["sslap/queue_wait"] == main


def test_no_profiler_range_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _, res = _solve(mode="hybrid")
    loc, val = _instance()
    PP.auction_solve_sharded_hybrid(loc=loc, val=val, shape=(N, N),
                                    mesh=PP.make_mesh([CPU] * 2))
    assert res["meta"]["soln_found"] and prof.spans()


def test_the_buffer_keeps_the_newest_max_spans():
    for _ in range(prof.MAX_SPANS + 10):
        with prof.span("x"):
            pass
    recs = prof.spans()
    assert len(recs) == prof.MAX_SPANS == 65536
    ids = [r["id"] for r in recs]
    assert ids == sorted(ids) and ids[-1] - ids[0] == prof.MAX_SPANS - 1


def test_a_parent_handed_to_a_thread_and_root_counters():
    got = {}
    with prof.entry() as root:
        with prof.entry() as again:         # a nested entry: the same root
            assert again is root
        caller = prof.current()

        def body():
            with prof.span("child", parent=caller, rank=3) as sp:
                with prof.span("grandchild") as g:
                    got["g"] = (g.parent, g.root, g.rank)
                got["sp"] = (sp.parent, sp.root)

        th = threading.Thread(target=body)
        th.start()
        th.join(timeout=60)
        assert not th.is_alive()
        root.count("hits", 2)
        root.count("hits")
    assert got["sp"] == (root.id, root.id)
    assert got["g"][1:] == (root.id, 3)
    names = _by_name(prof.spans())
    assert names["solve"][0]["counts"] == {"hits": 3}
    assert names["grandchild"][0]["parent"] == names["child"][0]["id"]


def test_trace_annotation_records_a_span_under_its_own_range(tmp_path):
    with prof.profile_trace(str(tmp_path)):
        with prof.trace_annotation("sslap_candidates_probe"):
            torch.arange(10).sum()
    (path,) = glob.glob(str(tmp_path / "trace_*.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "sslap_candidates_probe" in names
    assert [r["name"] for r in prof.spans()] == ["sslap_candidates_probe"]
