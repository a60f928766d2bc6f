"""The port's public API (sslap_tpu_torch.AuctionSolver) against the JAX
package's, on the CPU (``device="cpu"`` runs the kernels' twins).

The square hybrid and mode='cpu' must match the reference bit for bit:
solution, prices, round and bid counts, tier histogram and meta keys.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sslap_tpu as R
import sslap_tpu_torch as P
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
    dict(mode="device"), dict(mode="sharded"), dict(mode="overlapped"),
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
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        P.auction_solve(loc=loc, val=val, shape=(40, 60), mode="hybrid",
                        device="cpu")
    dense = rng.integers(1, 100, (64, 64))      # auto picks engine='dense'
    with pytest.raises(NotImplementedError, match="dense"):
        P.auction_solve(dense, mode="hybrid", device="cpu")
    assert P.auction_solve(dense, mode="hybrid", engine="compact",
                           device="cpu")["meta"]["soln_found"]
    with pytest.raises(ValueError, match="float64"):
        P.auction_solve(dense, mode="hybrid", dtype=np.float64,
                        device="cpu")


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
    code = ("import sys, sslap_tpu_torch, sslap_tpu_torch.hybrid; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'sslap_tpu.')) or m == 'sslap_tpu']; "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
