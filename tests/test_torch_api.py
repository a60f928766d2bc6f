"""The port's public API (sslap_tpu_torch.AuctionSolver) against the JAX
package's, on the CPU (``device="cpu"`` runs the kernels' twins).

The square and rectangular hybrid, mode='device' and mode='cpu' must
match the reference bit for bit: solution, prices, round and bid counts,
tier histogram and meta keys; hopcroft_solve and linear_sum_assignment
return the reference's arrays.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sslap_tpu as R
import sslap_tpu_torch as P
from scipy.optimize import linear_sum_assignment as scipy_lsa
from sslap_tpu import hybrid as RH
from sslap_tpu import ingest as RI
from sslap_tpu_torch import hybrid as PH
from sslap_tpu_torch.utils import profiling as prof
from tests.utils import random_sparse_instance, scipy_sparse_objective

REPO = Path(__file__).resolve().parent.parent


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _instance(seed, n, integer, k=8):
    """bench.make_instance's shape: k random columns per row plus a
    planted permutation."""
    rng = np.random.default_rng(seed)
    rr = np.concatenate([np.repeat(np.arange(n), k), np.arange(n)])
    cc = np.concatenate([rng.integers(0, n, n * k), rng.permutation(n)])
    _, idx = np.unique(rr * n + cc, return_index=True)
    rr, cc = rr[idx], cc[idx]
    if integer:
        val = rng.integers(1, 1000, rr.shape[0])
    else:
        val = (rng.random(rr.shape[0]) * 999 + 1).astype(np.float32)
    return np.stack([rr, cc], 1), val


def _assert_same(r, p):
    np.testing.assert_array_equal(p["sol"], r["sol"])
    assert p["prices"].dtype == r["prices"].dtype
    np.testing.assert_array_equal(_bits(p["prices"]), _bits(r["prices"]))
    assert set(p["meta"]) == set(r["meta"])
    for k in ("its", "host_bids", "phases", "tier_rounds", "final_eps",
              "unassigned", "soln_found", "obj", "mode"):
        assert p["meta"].get(k) == r["meta"].get(k), k


@pytest.mark.parametrize("case", [
    dict(integer=True, wide_rounds=False),
    dict(integer=True, wide_rounds=True, theta=10.0),
    dict(integer=False, wide_rounds=False, problem="max"),
    dict(integer=False, wide_rounds=True),
    dict(integer=False, wide_rounds=False, theta=10.0, n=3000),
])
def test_hybrid_matches_reference(case):
    case = dict(case)
    integer = case.pop("integer")
    n = case.pop("n", 1500)
    loc, val = _instance(7, n, integer)
    r = R.AuctionSolver(loc=loc, val=val, shape=(n, n), mode="hybrid",
                        **case).solve()
    p = P.AuctionSolver(loc=loc, val=val, shape=(n, n), mode="hybrid",
                        device="cpu", **case).solve()
    _assert_same(r, p)
    assert p["meta"]["soln_found"] and p["meta"]["its"] > 0
    assert {"device_time", "readback_time", "host_gs_time"} <= set(p["meta"])
    if integer:
        want = scipy_sparse_objective(loc, val, n, n,
                                      maximize=case.get("problem") == "max")
        assert p["meta"]["obj"] == int(round(want))


@pytest.mark.parametrize("kind", ["int", "float32", "float64"])
def test_cpu_mode_matches_reference(kind):
    n = 400
    loc, val = _instance(8, n, kind == "int")
    dtype = np.float64 if kind == "float64" else None
    r = R.AuctionSolver(loc=loc, val=val, shape=(n, n), mode="cpu",
                        dtype=dtype).solve()
    p = P.AuctionSolver(loc=loc, val=val, shape=(n, n), mode="cpu",
                        dtype=dtype).solve()
    _assert_same(r, p)
    # auto routes below the hybrid crossover (and float64) to 'cpu'
    a = P.AuctionSolver(loc=loc, val=val, shape=(n, n),
                        dtype=dtype).solve()
    _assert_same(r, a)


def test_rectangular_cpu_mode_matches_reference():
    rng = np.random.default_rng(9)
    loc, val, _ = random_sparse_instance(rng, 120, 180, 0.05)
    r = R.auction_solve(loc=loc, val=val, shape=(120, 180), mode="cpu")
    p = P.auction_solve(loc=loc, val=val, shape=(120, 180), mode="cpu")
    _assert_same(r, p)
    want = scipy_sparse_objective(loc, val, 120, 180)
    assert p["meta"]["obj"] == int(round(want))


@pytest.mark.parametrize("max_iter", [3, 15])
def test_hybrid_round_budget_meta_matches_reference(max_iter):
    """A device pass cut by max_iter before eps_min: the host tail still
    completes the assignment, and soln_found/final_eps say honestly
    whether eps_min was reached, as in the reference."""
    n = 1500
    loc, val = _instance(17, n, False)
    kw = dict(loc=loc, val=val, shape=(n, n), mode="hybrid", theta=10.0,
              max_iter=max_iter)
    r = R.AuctionSolver(**kw).solve()
    p = P.AuctionSolver(device="cpu", **kw).solve()
    _assert_same(r, p)
    assert p["meta"]["its"] >= max_iter
    assert p["meta"]["unassigned"] == 0
    assert not p["meta"]["soln_found"]        # eps_min was not reached


def test_cached_and_warm_resolves_match_reference():
    """A second solve() reuses the solver's device data; warm prices (raw,
    relaxed and forward-reverse tightened) follow the reference."""
    n = 1200
    loc, val = _instance(10, n, False)
    rs = R.AuctionSolver(loc=loc, val=val, shape=(n, n), mode="hybrid",
                         theta=10.0)
    ps = P.AuctionSolver(loc=loc, val=val, shape=(n, n), mode="hybrid",
                         theta=10.0, device="cpu")
    r1, p1 = rs.solve(), ps.solve()
    _assert_same(r1, p1)
    ell = ps._device_cache["ell"]
    p2 = ps.solve()
    assert ps._device_cache["ell"] is ell
    _assert_same(r1, p2)
    val2 = val * np.float32(1.01)
    for kw in (dict(), dict(warm_relax=0.9), dict(warm_mode="fr")):
        rw = R.AuctionSolver(loc=loc, val=val2, shape=(n, n), mode="hybrid",
                             theta=10.0).solve(warm_prices=r1["prices"],
                                               **kw)
        pw = P.AuctionSolver(loc=loc, val=val2, shape=(n, n), mode="hybrid",
                             theta=10.0, device="cpu").solve(
                                 warm_prices=p1["prices"], **kw)
        _assert_same(rw, pw)


def test_config_object_and_auction_solve():
    n = 300
    loc, val = _instance(11, n, True)
    cfg = P.AuctionConfig(problem="max", mode="hybrid")
    p = P.auction_solve(loc=loc, val=val, shape=(n, n), config=cfg,
                        device="cpu")
    r = R.auction_solve(loc=loc, val=val, shape=(n, n),
                        config=R.AuctionConfig(problem="max", mode="hybrid"))
    _assert_same(r, p)


def test_infeasible_raises():
    loc = np.array([[0, 0], [1, 0], [2, 1], [2, 2]])
    val = np.array([1, 2, 3, 4])
    with pytest.raises(R.InfeasibleError):
        R.auction_solve(loc=loc, val=val, shape=(3, 3))
    for mode in ("cpu", "hybrid"):
        with pytest.raises(P.InfeasibleError):
            P.auction_solve(loc=loc, val=val, shape=(3, 3), mode=mode,
                            device="cpu")
    assert issubclass(P.InfeasibleError, ValueError)


_TIMERS = ("time", "device_time", "readback_time", "host_gs_time")
# the sharded hybrid's meta keys that do not depend on the shard count
_SHARD_FREE = ("its", "host_bids", "phases", "final_eps", "unassigned",
               "soln_found", "obj", "mode")


@pytest.mark.parametrize("kw", [
    dict(engine="candidates", mode="sharded_hybrid"),
    dict(engine="candidates"), dict(engine="candidates", mode="hybrid"),
    dict(engine="candidates", mode="device"),
])
def test_candidates_engine_matches_reference(kw):
    """engine='candidates' (formerly refused) through AuctionSolver and
    auction_solve equals the reference's: sol, prices bits and every meta
    key but the timers, min and max, integer and float32 costs.  'auto'
    routes this size to 'cpu' in both packages, and 'sharded_hybrid'
    ignores the engine (the reference runs it on eight virtual devices,
    the port on one CPU shard, so there the keys that depend on the shard
    count are left out)."""
    n = 300
    for problem in ("min", "max"):
        for integer in (True, False):
            loc, val = _instance(12 + integer, n, integer)
            args = dict(loc=loc, val=val, shape=(n, n), problem=problem,
                        **kw)
            r = R.AuctionSolver(**args).solve()
            outs = (P.AuctionSolver(**args, device="cpu").solve(),
                    P.auction_solve(**args, device="cpu"))
            for p in outs:
                np.testing.assert_array_equal(p["sol"], r["sol"])
                assert p["prices"].dtype == r["prices"].dtype
                np.testing.assert_array_equal(_bits(p["prices"]),
                                              _bits(r["prices"]))
                assert set(p["meta"]) == set(r["meta"])
                keys = set(r["meta"]) - set(_TIMERS)
                if kw.get("mode") == "sharded_hybrid":
                    keys = _SHARD_FREE
                for k in keys:
                    assert p["meta"][k] == r["meta"][k], k
                assert p["meta"]["soln_found"], (problem, integer)


def test_mode_sharded_hybrid_solves_as_the_reference():
    """mode='sharded_hybrid' (formerly refused) routes to the sharded
    hybrid: AuctionSolver on the CPU (one shard) equals the reference's
    (eight virtual devices) in sol, prices and the rounds, which do not
    depend on the shard count (trunc > 0, no ladder balance); the rounds
    by tier and the comm bytes do."""
    loc, val = _instance(12, 50, True)
    r = R.AuctionSolver(loc=loc, val=val, shape=(50, 50),
                        mode="sharded_hybrid").solve()
    p = P.AuctionSolver(loc=loc, val=val, shape=(50, 50),
                        mode="sharded_hybrid", device="cpu").solve()
    np.testing.assert_array_equal(p["sol"], r["sol"])
    np.testing.assert_array_equal(_bits(p["prices"]), _bits(r["prices"]))
    assert set(p["meta"]) == set(r["meta"])
    for k in ("its", "host_bids", "phases", "final_eps", "unassigned",
              "soln_found", "obj", "mode"):
        assert p["meta"][k] == r["meta"][k], k
    assert (p["meta"]["n_shards"], r["meta"]["n_shards"]) == (1, 8)


def test_mode_overlapped_solves_as_the_reference():
    """mode='overlapped' (formerly refused) routes to the overlapped
    row-sharded solve: AuctionSolver and auction_solve on the CPU equal
    the reference's (which runs on the eight virtual devices: the result
    does not depend on the shard count)."""
    loc, val = _instance(12, 50, True)
    r = R.AuctionSolver(loc=loc, val=val, shape=(50, 50),
                        mode="overlapped").solve()
    p = P.AuctionSolver(loc=loc, val=val, shape=(50, 50), mode="overlapped",
                        device="cpu").solve()
    _assert_same(r, p)
    assert p["meta"]["overlap"] is True and p["meta"]["soln_found"]
    _assert_same(r, P.auction_solve(loc=loc, val=val, shape=(50, 50),
                                    mode="overlapped", device="cpu"))


def test_unported_paths_raise_instead_of_rerouting():
    rng = np.random.default_rng(13)
    loc, val, _ = random_sparse_instance(rng, 40, 60, 0.1)
    # the rectangular hybrid is ported: it solves, as the reference does
    _assert_same(R.auction_solve(loc=loc, val=val, shape=(40, 60),
                                 mode="hybrid"),
                 P.auction_solve(loc=loc, val=val, shape=(40, 60),
                                 mode="hybrid", device="cpu"))
    dense = rng.integers(1, 100, (64, 64))      # auto picks engine='dense'
    got = P.auction_solve(dense, mode="hybrid", device="cpu")
    assert got["meta"]["engine"] == "dense"
    _assert_same(R.auction_solve(dense, mode="hybrid"), got)
    assert P.auction_solve(dense, mode="hybrid", engine="compact",
                           device="cpu")["meta"]["soln_found"]
    for mode in ("hybrid", "device"):
        with pytest.raises(ValueError, match="float64"):
            P.auction_solve(dense, mode=mode, dtype=np.float64,
                            device="cpu")


@pytest.mark.parametrize("case", [
    dict(integer=True), dict(integer=False),
    dict(integer=True, keep_assignment=False),
    dict(integer=False, problem="max", warm=True),
])
def test_rectangular_hybrid_matches_reference(case):
    """The per-phase path with device rounds (threshold 16, so this small
    instance runs them) and the native dummy-heap GS between phases."""
    case = dict(case)
    integer, warm = case.pop("integer"), case.pop("warm", False)
    n, m = 150, 260
    rng = np.random.default_rng(21)
    loc, val, _ = random_sparse_instance(rng, n, m, 0.04, integer=integer)
    if not integer:
        val = val.astype(np.float32)
    kw = dict(mode="hybrid", threshold=16, **case)
    if warm:
        kw["warm_prices"] = P.auction_solve(
            loc=loc, val=val, shape=(n, m), mode="cpu",
            problem=case["problem"])["prices"] * np.float32(0.9)
    rs, rp, rm = RH.solve_hybrid(RI.from_coo(loc, val, shape=(n, m)), **kw)
    ps, pp, pm = PH.solve_hybrid(P.from_coo(loc, val, shape=(n, m)),
                                 device="cpu", **kw)
    np.testing.assert_array_equal(ps, rs)
    np.testing.assert_array_equal(_bits(pp), _bits(rp))
    assert set(pm) == set(rm)
    for k in ("its", "host_bids", "phases", "final_eps", "unassigned",
              "soln_found", "mode"):
        assert pm[k] == rm[k], k
    assert pm["its"] > 0 and pm["soln_found"]


def test_rectangular_hybrid_solver_matches_reference():
    """Through AuctionSolver, with more than threshold = 4096 rows and
    dummies to place, so the device phases run at the default."""
    n, m = 2500, 4500
    rng = np.random.default_rng(22)
    rr = np.repeat(np.arange(n), 6)
    cc = rng.integers(0, m, n * 6)
    rr = np.concatenate([rr, np.arange(n)])
    cc = np.concatenate([cc, rng.permutation(m)[:n]])
    _, idx = np.unique(rr * m + cc, return_index=True)
    loc = np.stack([rr[idx], cc[idx]], 1)
    val = rng.integers(1, 1000, idx.shape[0])
    r = R.AuctionSolver(loc=loc, val=val, shape=(n, m), mode="hybrid").solve()
    p = P.AuctionSolver(loc=loc, val=val, shape=(n, m), mode="hybrid",
                        device="cpu").solve()
    _assert_same(r, p)
    assert p["meta"]["its"] > 0 and p["meta"]["soln_found"]
    assert p["meta"]["obj"] == int(round(scipy_sparse_objective(loc, val, n,
                                                                m)))


@pytest.mark.parametrize("case", [
    dict(n=300, integer=True), dict(n=300, integer=False, problem="max"),
    dict(n=300, integer=True, keep_assignment=False),
    dict(n=120, m=200, integer=True), dict(n=120, m=200, integer=False),
    dict(n=300, integer=False, warm=True),
])
def test_device_mode_matches_reference(case):
    """mode='device': the tiered solve for square problems that keep the
    assignment, the full-width Jacobi solve for the rest."""
    case = dict(case)
    n, m = case.pop("n"), case.pop("m", None)
    integer, warm = case.pop("integer"), case.pop("warm", False)
    if m is None:
        loc, val = _instance(23, n, integer)
        m = n
    else:
        rng = np.random.default_rng(23)
        loc, val, _ = random_sparse_instance(rng, n, m, 0.05,
                                             integer=integer)
        val = val if integer else val.astype(np.float32)
    kw = dict(loc=loc, val=val, shape=(n, m), mode="device", **case)
    r = R.AuctionSolver(**kw)
    p = P.AuctionSolver(device="cpu", **kw)
    if warm:
        r1, p1 = r.solve(), p.solve()
        _assert_same(r1, p1)
        r, p = (r.solve(warm_prices=r1["prices"], warm_relax=0.9),
                p.solve(warm_prices=p1["prices"], warm_relax=0.9))
    else:
        r, p = r.solve(), p.solve()
    if not p["meta"]["soln_found"]:
        # the rectangular float Jacobi solve spends its max_iter above
        # eps_min with every row assigned: the reference reports that stop
        # as a solution (ROADMAP queue 3), the port does not
        assert p["meta"]["unassigned"] == 0 and p["meta"]["obj"] is None
        assert p["meta"]["final_eps"] > 1 / (m + 1) and r["meta"]["soln_found"]
        r = dict(r, meta=dict(r["meta"], soln_found=False, obj=None))
    _assert_same(r, p)
    assert p["meta"]["mode"] == "device"
    assert p["meta"]["soln_found"] or (m, integer) == (200, False)
    if integer:
        assert p["meta"]["obj"] == int(round(scipy_sparse_objective(
            loc, val, n, m, maximize=case.get("problem") == "max")))


def test_auto_without_native_runtime_picks_device(monkeypatch):
    loc, val = _instance(24, 200, True)
    monkeypatch.setattr(PH, "native_available", lambda: False)
    p = P.auction_solve(loc=loc, val=val, shape=(200, 200), device="cpu")
    r = R.auction_solve(loc=loc, val=val, shape=(200, 200), mode="device")
    _assert_same(r, p)


def test_hopcroft_solve_matches_reference():
    rng = np.random.default_rng(25)
    _, _, dense = random_sparse_instance(rng, 40, 40, 0.08)
    np.testing.assert_array_equal(P.hopcroft_solve(dense),
                                  R.hopcroft_solve(dense))
    loc, _, _ = random_sparse_instance(rng, 50, 80, 0.04)
    loc = loc[rng.permutation(loc.shape[0])[:int(0.8 * loc.shape[0])]]
    loc = loc[loc[:, 0] != 7]                   # row 7 stays unmatched
    got = P.hopcroft_solve(loc=loc, shape=(50, 80))
    np.testing.assert_array_equal(got, R.hopcroft_solve(loc=loc,
                                                        shape=(50, 80)))
    assert got.dtype == np.int64 and (got >= 0).sum() < 50
    # warm: a stale matching with a vanished edge and a duplicated column
    warm = got.copy()
    warm[np.flatnonzero(got >= 0)[:3]] = got[np.flatnonzero(got >= 0)[3]]
    warm[np.flatnonzero(got < 0)[0]] = 79
    np.testing.assert_array_equal(
        P.hopcroft_solve(loc=loc, shape=(50, 80), warm=warm),
        R.hopcroft_solve(loc=loc, shape=(50, 80), warm=warm))
    with pytest.raises(ValueError, match="loc"):
        P.hopcroft_solve()


@pytest.mark.parametrize("shape,maximize,low", [
    ((30, 45), False, 0), ((45, 30), False, 0), ((40, 40), True, 0),
    ((35, 50), False, -500), ((50, 35), True, -500),
])
def test_linear_sum_assignment_matches_reference_and_scipy(shape, maximize,
                                                           low):
    rng = np.random.default_rng(26)
    cost = rng.integers(low, 1000, shape).astype(np.float64)
    got = P.linear_sum_assignment(cost, maximize=maximize, device="cpu")
    ref = R.linear_sum_assignment(cost, maximize=maximize)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    r, c = scipy_lsa(cost, maximize=maximize)
    assert got[0].shape == r.shape
    assert cost[got].sum() == cost[r, c].sum()


def test_hybrid_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    loc, val = _instance(14, 100, True)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.auction_solve(loc=loc, val=val, shape=(100, 100), mode="hybrid")


def test_csr_to_csc_ignores_over_allocated_indices():
    """One nnz extent (indptr[-1]) bounds the argsort, the gathers and the
    column counts: entries past nnz in an over-allocated buffer are not
    data (the reference's two-extent defect is not carried over)."""
    n = 300
    loc, val = _instance(15, n, False)
    prob = P.from_coo(loc, val, shape=(n, n))
    indptr, indices, data = PH.ell_to_csr_transformed(prob, -1, 1)
    exact = PH._csr_to_csc(indptr, indices, data, n, n)
    junk = np.full(57, 3, indices.dtype)
    big = PH._csr_to_csc(indptr, np.concatenate([indices, junk]),
                         np.concatenate([data, np.ones(57, data.dtype)]),
                         n, n)
    for a, b in zip(exact, big):
        np.testing.assert_array_equal(a, b)
    cindptr, cindices, cvals = exact
    assert cindptr[-1] == indptr[-1] == cindices.shape[0]
    dense = np.zeros((n, n), np.float32)
    dense[np.repeat(np.arange(n), np.diff(indptr)), indices] = data
    cols = np.repeat(np.arange(n), np.diff(cindptr))
    np.testing.assert_array_equal(dense[cindices, cols], cvals)


def _numpy_csc(monkeypatch, *args):
    """``_csr_to_csc`` with the native transpose taken away: numpy's
    stable argsort."""
    with monkeypatch.context() as mp:
        mp.setattr(PH._native, "csr_to_csc_native", None)
        return PH._csr_to_csc(*args)


def _csr_case(case, dtype):
    """A random CSR (indptr, indices, data, n, m) with empty rows and empty
    columns; 'threaded' is above the native transpose's one-thread cut-off
    (2**20 entries a thread), 'over_allocated' has junk past nnz."""
    rng = np.random.default_rng(27)
    n, m, k = {"small": (500, 500, 6), "rect": (300, 700, 5),
               "over_allocated": (400, 400, 7),
               "threaded": (300_000, 350_000, 11)}[case]
    counts = rng.integers(0, 2 * k, n)
    counts[rng.random(n) < 0.1] = 0                      # empty rows
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    nnz = int(indptr[-1])
    indices = rng.integers(0, m - m // 10, nnz).astype(np.int32)  # empty cols
    if dtype == np.int32:
        data = rng.integers(-1000, 1000, nnz).astype(np.int32)
    else:
        data = rng.standard_normal(nnz).astype(dtype)
    if case == "over_allocated":
        indices = np.concatenate([indices, np.full(57, 3, np.int32)])
        data = np.concatenate([data, np.ones(57, dtype)])
    return indptr, indices, data, n, m


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
@pytest.mark.parametrize("case", ["small", "rect", "over_allocated",
                                  "threaded"])
def test_native_csc_equals_numpy_bit_for_bit(monkeypatch, case, dtype):
    if not PH.native_available():
        pytest.skip("native runtime not built")
    args = _csr_case(case, dtype)
    got = P._native.csr_to_csc_native(*args)
    want = _numpy_csc(monkeypatch, *args)
    nnz = int(args[0][-1])
    assert got[0].shape == (args[4] + 1,) and got[1].shape == (nnz,)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    if case == "over_allocated":       # junk past nnz changes nothing
        exact = _numpy_csc(monkeypatch, args[0], args[1][:nnz],
                           args[2][:nnz], args[3], args[4])
        for a, b in zip(got, exact):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("mode", ["hybrid", "cpu"])
def test_fr_tail_same_with_native_and_numpy_csc(monkeypatch, integer, mode):
    """The square solve's FR tail reads the native CSC and numpy's alike:
    the same sigma, prices, host bids and rounds; the build is the
    ``csc`` span inside ``host_tables``."""
    if not PH.native_available():
        pytest.skip("native runtime not built")
    n = 1500
    loc, val = _instance(28, n, integer)
    kw = dict(loc=loc, val=val, shape=(n, n), mode=mode, device="cpu",
              gs_engine="fr")
    prof.clear()
    nat = P.AuctionSolver(**kw).solve()
    recs = {r["id"]: r for r in prof.spans()}
    csc = [r for r in recs.values() if r["name"] == "csc"]
    assert len(csc) == 1 and recs[csc[0]["parent"]]["name"] == "host_tables"
    monkeypatch.setattr(PH._native, "csr_to_csc_native", None)
    ref = P.AuctionSolver(**kw).solve()
    np.testing.assert_array_equal(nat["sol"], ref["sol"])
    np.testing.assert_array_equal(_bits(nat["prices"]), _bits(ref["prices"]))
    for k in ("its", "host_bids", "final_eps", "obj", "soln_found"):
        assert nat["meta"][k] == ref["meta"][k], k
    assert nat["meta"]["host_bids"] > 0


def test_import_leaves_jax_out():
    code = ("import sys, sslap_tpu_torch, sslap_tpu_torch.hybrid, "
            "sslap_tpu_torch.ops.probe_gs; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'sslap_tpu.')) or m == 'sslap_tpu']; "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ---- engine='dense': the single-instance route into the batched dense
# engine (the mirror of tests/test_dense_engine.py, port against reference)


def _dense_instance(n, seed=0, forbidden_frac=0.0):
    rng = np.random.default_rng(seed)
    C = rng.integers(1, 1000, (n, n)).astype(np.float32)
    if forbidden_frac:
        mask = rng.random((n, n)) < forbidden_frac
        np.fill_diagonal(mask, False)        # keep it feasible
        C = np.where(mask, -1.0, C)
    return C


def _scipy_obj(C, maximize=False):
    A = C.astype(np.float64)
    A = np.where(C < 0, -np.inf if maximize else np.inf, A)
    r, c = scipy_lsa(A, maximize=maximize)
    return float(C.astype(np.float64)[r, c].sum())


@pytest.mark.parametrize("case", [
    dict(n=96), dict(n=64, seed=3, forbidden_frac=0.3),
    dict(n=48, seed=5, problem="max"), dict(n=40, seed=6, integer=True),
])
def test_dense_engine_matches_reference_and_scipy(case):
    case = dict(case)
    n, problem = case.pop("n"), case.pop("problem", "min")
    integer = case.pop("integer", False)
    C = _dense_instance(n, **case)
    C = C.astype(np.int64) if integer else C
    r = R.auction_solve(C, mode="hybrid", engine="dense", problem=problem)
    p = P.auction_solve(C, mode="hybrid", engine="dense", problem=problem,
                        device="cpu")
    _assert_same(r, p)
    assert p["meta"]["soln_found"] and p["meta"]["engine"] == "dense"
    assert p["meta"]["mode"] == "hybrid"
    assert p["meta"]["obj"] == _scipy_obj(C, maximize=problem == "max")
    assert (C[np.arange(n), p["sol"]] >= 0).all()


def test_auto_engine_picks_dense_and_keeps_compact_for_sparse():
    C = _dense_instance(64, seed=7)
    s = P.AuctionSolver(C, mode="hybrid", device="cpu")      # engine='auto'
    res = s.solve()
    assert res["meta"]["engine"] == "dense"
    _assert_same(R.AuctionSolver(C, mode="hybrid").solve(), res)
    assert s.prices is not None and s.prices.shape == (64,)
    rng = np.random.default_rng(11)
    n = 64
    S = np.full((n, n), -1.0)
    S[np.arange(n), rng.permutation(n)] = 5.0
    S[np.arange(n), np.arange(n)] = rng.integers(1, 9, n).astype(float)
    res = P.AuctionSolver(S, mode="hybrid", device="cpu").solve()
    assert res["meta"].get("engine") != "dense" and res["meta"]["soln_found"]
    # a warm-started solve keeps the compact engine, as in the reference
    warm = P.AuctionSolver(C, mode="hybrid", device="cpu").solve(
        warm_prices=s.prices)
    assert warm["meta"].get("engine") != "dense"


def test_dense_engine_requires_hybrid_and_rejects_warm_prices():
    C = _dense_instance(32)
    for mode in ("device", "cpu"):
        with pytest.raises(ValueError, match="mode='hybrid'"):
            P.auction_solve(C, mode=mode, engine="dense", device="cpu")
    s = P.AuctionSolver(C, mode="hybrid", engine="dense", device="cpu")
    with pytest.raises(ValueError, match="warm_prices"):
        s.solve(warm_prices=np.zeros(32, np.float32))
    with pytest.raises(ValueError, match="engine='dense' needs"):
        P.auction_solve(C[:20], mode="hybrid", engine="dense", device="cpu")


def test_dense_engine_config_bundle_and_serving_cache():
    C = _dense_instance(48, seed=9)
    cfg = P.AuctionConfig(mode="hybrid", engine="dense")
    res = P.auction_solve(C, config=cfg, device="cpu")
    _assert_same(R.auction_solve(C, config=R.AuctionConfig(
        mode="hybrid", engine="dense")), res)
    assert res["meta"]["engine"] == "dense"
    # construct once: the second solve() reuses the dense block and the
    # host CSR and returns the same assignment
    C = _dense_instance(64, seed=3)
    s = P.AuctionSolver(C, mode="hybrid", engine="dense", device="cpu")
    r1 = s.solve()
    assert "dense_dev" in s._device_cache and "dense_csr" in s._device_cache
    dev_before = s._device_cache["dense_dev"]
    r2 = s.solve()
    assert s._device_cache["dense_dev"] is dev_before
    _assert_same(r1, r2)
    assert r2["meta"]["obj"] == _scipy_obj(C)
