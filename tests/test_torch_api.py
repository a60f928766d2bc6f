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


@pytest.mark.parametrize("kw", [
    dict(mode="sharded"), dict(mode="overlapped"),
    dict(mode="sharded_hybrid"), dict(engine="candidates"),
    dict(engine="dense"),
])
def test_unported_modes_and_engines_raise(kw):
    loc, val = _instance(12, 50, True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        P.AuctionSolver(loc=loc, val=val, shape=(50, 50), device="cpu",
                        **kw).solve()


def test_unported_paths_raise_instead_of_rerouting():
    rng = np.random.default_rng(13)
    loc, val, _ = random_sparse_instance(rng, 40, 60, 0.1)
    # the rectangular hybrid is ported: it solves, as the reference does
    _assert_same(R.auction_solve(loc=loc, val=val, shape=(40, 60),
                                 mode="hybrid"),
                 P.auction_solve(loc=loc, val=val, shape=(40, 60),
                                 mode="hybrid", device="cpu"))
    dense = rng.integers(1, 100, (64, 64))      # auto picks engine='dense'
    with pytest.raises(NotImplementedError, match="dense"):
        P.auction_solve(dense, mode="hybrid", device="cpu")
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
    _assert_same(r, p)
    assert p["meta"]["soln_found"] and p["meta"]["mode"] == "device"
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
