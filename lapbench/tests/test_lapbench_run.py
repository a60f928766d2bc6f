"""Whole runs of every cell on the CPU at small sizes (the chip look
skipped, the program on device='cpu'): the result line, the control,
and each fault the cell can have, planted under the timed path, which
the check must call not correct."""

import json
import sys

import numpy as np
import pytest
import torch

from lapbench import drivers, harness
from lapbench.entries import batch as batch_entry
from lapbench.entries import solver as solver_entry

SMALL = {
    "sparse1M.cold": {"n": 1500, "m": 1500},
    "sparse1M.track": {"n": 1500, "m": 1500},
    "batch256.cold": {"n": 128, "m": 128, "instances": 6,
                      "nnz_per_row": 16, "pad_to": 20},
    "rowpart1M.4card": {"n": 1200, "m": 1200},
}
SEED = 2 ** 31 + 77


def _run(cell, trace=False, control=False, seconds=0.3):
    return harness.run_cell(cell, SEED, seconds, trace, device="cpu",
                            overrides=SMALL[cell], control=control)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct_and_well_formed(cell):
    r = _run(cell)
    assert r["correct"] is True, r["checks"]
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["failed"] == 0 and r["attempted"] >= 1
    spec = harness.load_cell(cell)
    assert set(r["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    for m in r["metrics"].values():
        assert m["value"] > 0 and isinstance(m["unit"], str)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(r["device"])
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(r)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_traced_run_reports_per_layer_metrics(cell):
    r = _run(cell, trace=True)
    assert r["correct"] is True
    assert {"busy_s", "window_s"} <= set(r["device"])
    names = {m["name"] for m in harness.load_cell(cell)["per_layer"]}
    assert set(r["metrics"]) <= names
    assert any(k.startswith("ingest_s.") for k in r["metrics"])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_bfloat16_control_is_not_correct(cell):
    r = _run(cell, control=True)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


class _Broken:
    """AuctionSolver with its answer broken as ``how`` says."""

    last = None

    def __init__(self, how, *a, **kw):
        self.how, self.inner = how, drivers_real(*a, **kw)

    def solve(self, **kw):
        res = self.inner.solve(**kw)
        if self.how == "stale" and _Broken.last is not None:
            res = _Broken.last               # the state left unchanged
        elif self.how == "coarse_eps":
            # the schedule reported as stopped at twice eps_min
            meta = dict(res["meta"], final_eps=2 * res["meta"]["final_eps"])
            res = dict(res, meta=meta)
        elif self.how == "altered":
            sol = np.array(res["sol"])
            sol[[0, 1]] = sol[[1, 0]]        # an answer altered
            res = dict(res, sol=sol)
        elif self.how == "no_exchange":
            # shards 1-3 commit their rows' own best columns, never seeing
            # the other shards' bids
            sol = np.array(res["sol"])
            loc, val = self.loc, self.val
            n = sol.shape[0]
            best = np.full(n, np.inf)
            col = sol.copy()
            for (r, c), v in zip(loc, val):
                if r >= n // 4 and v < best[r]:
                    best[r], col[r] = v, c
            res = dict(res, sol=col)
        _Broken.last = res
        return res


drivers_real = solver_entry.AuctionSolver


def _plant(monkeypatch, how):
    _Broken.last = None

    def make(*a, **kw):
        b = _Broken(how, *a, **kw)
        b.loc, b.val = kw["loc"], kw["val"]
        return b
    monkeypatch.setattr(solver_entry, "AuctionSolver", make)


@pytest.mark.parametrize("cell,how", [
    ("sparse1M.cold", "stale"), ("sparse1M.cold", "altered"),
    ("sparse1M.cold", "coarse_eps"),
    ("sparse1M.track", "stale"), ("sparse1M.track", "altered"),
    ("sparse1M.track", "coarse_eps"),
    ("rowpart1M.4card", "stale"), ("rowpart1M.4card", "altered"),
    ("rowpart1M.4card", "no_exchange"), ("rowpart1M.4card", "coarse_eps")])
def test_planted_faults_are_not_correct(monkeypatch, cell, how):
    _plant(monkeypatch, how)
    r = _run(cell, seconds=0.5)
    assert r["attempted"] >= 2
    assert r["correct"] is False, (how, r["checks"])


@pytest.mark.parametrize("how", ["half", "altered", "coarse_eps"])
def test_planted_batch_faults_are_not_correct(monkeypatch, how):
    real = batch_entry.auction_solve_batched

    def broken(stacked, **kw):
        sols, metas = real(stacked, **kw)
        sols = np.array(sols)
        if how == "half":            # half of the batch left out
            h = sols.shape[0] // 2
            sols[h:] = sols[:sols.shape[0] - h]
            metas = metas[:h] + metas[:len(metas) - h]
        elif how == "coarse_eps":
            metas = [dict(mt, final_eps=2 * mt["final_eps"]) for mt in metas]
        else:
            sols[0, [0, 1]] = sols[0, [1, 0]]
        return sols, metas
    monkeypatch.setattr(batch_entry, "auction_solve_batched", broken)
    r = _run("batch256.cold")
    assert r["correct"] is False, r["checks"]


def test_a_request_that_raises_fails_the_run(monkeypatch):
    calls = []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("planted")
        return drivers_real(*a, **kw)
    monkeypatch.setattr(solver_entry, "AuctionSolver", flaky)
    r = _run("sparse1M.cold", seconds=0.5)
    assert r["failed"] == 1 and r["correct"] is False


def test_patterns_generators_and_entries_are_found_by_name(monkeypatch):
    """A module put under a new name is what a configuration or traffic
    mix naming it runs: no edit to the driver."""
    import types
    seen = []
    gen_mod = types.ModuleType("lapbench.generators.tiny")
    gen_mod.make = lambda config, seed, k: {
        "loc": [np.array([[0, 0], [1, 1]])], "vals": [np.ones(2, np.float32)]}
    pat_mod = types.ModuleType("lapbench.patterns.once")

    class Pattern:
        def __init__(self, driver, seed):
            self.driver, self.pool = driver, [driver.make(seed, 0)]

        def request(self, k, spans):
            return self.driver.call(k, 0, spans)
    pat_mod.Pattern = Pattern
    ent_mod = types.ModuleType("lapbench.entries.echo")
    ent_mod.call = lambda driver, item, k, spans, **kw: (
        seen.append(k) or {"sigma": np.arange(2), "prices": None,
                           "obj": [2.0], "found": [True], "meta": [{}]})
    for mod in (gen_mod, pat_mod, ent_mod):
        monkeypatch.setitem(sys.modules, mod.__name__, mod)
    d = drivers.Driver({"entry": "echo", "generator": "tiny", "n": 2,
                        "m": 2}, {"pattern": "once"}, 5, device="cpu")
    rec = d.request(3, drivers.Spans())
    assert seen == [3] and rec["req"] == 3 and rec["inst"] == 0
    with pytest.raises(ValueError):
        drivers.plugin("patterns", "../cold")


@pytest.mark.cuda
def test_a_small_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = harness.run_cell("sparse1M.cold", SEED, 1.0, True, device="cuda",
                         overrides={"n": 20_000, "m": 20_000})
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0
