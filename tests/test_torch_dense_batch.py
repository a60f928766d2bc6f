"""The port's dense-chunk batched engine (sslap_tpu_torch.dense_batch) and
its dense bid op (DK, ops.dense_bid) against the JAX package's
``sslap_tpu.dense_batch``, on the CPU (DK's plain twin; JAX on the CPU).

Tolerance: exact.  DK's targets and bid bits equal ``_dense_bids``'s;
``_solve_chunk`` equals the vmapped reference per lane (prices bits, sigma,
rounds, phases, final eps); ``solve_batched_dense_hybrid`` returns the
reference's solutions, prices and meta apart from the timers.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sslap_tpu import dense_batch as RD
from sslap_tpu import ingest as RI
from sslap_tpu.batch import stack_problems as r_stack
from sslap_tpu_torch import auction as PA
from sslap_tpu_torch import dense_batch as PD
from sslap_tpu_torch import ingest as PI
from sslap_tpu_torch.batch import stack_problems as p_stack
from sslap_tpu_torch.ops import dense_bid, dense_bid_plain
from tests.utils import random_sparse_instance

TIMERS = ("time", "device_time", "host_gs_time")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _dense_rows(rng, B, n, m, dtype):
    """[B, n, m] values with missing entries = the neg sentinel: rows with
    0, 1 and 2 entries, value ties, and (float32) values and prices for
    which (a - p) + p != a."""
    neg = PA.neg_sentinel_np(dtype)
    mask = rng.random((B, n, m)) < 0.5
    mask[:, 0] = False                        # no entry
    mask[:, 1] = False
    mask[:, 1, 3] = True                      # one entry
    mask[:, 2] = False
    mask[:, 2, [1, 5]] = True                 # two entries
    if dtype == np.float32:
        vals = -(rng.random((B, n, m)) * 999 + 1).astype(np.float32)
        vals[:, 3:6] = -np.float32(2.5) * rng.integers(1, 4, (B, 3, m))
        prices = (rng.random((B, m)) * 300).astype(np.float32)
        prices[:, ::4] = 1.25 * rng.integers(0, 3, (B, (m + 3) // 4))
        eps = np.array([0.37, 1.5], np.float32)[:B]
        bigp = np.float32(1000.0)
    else:
        vals = -rng.integers(1, 6, (B, n, m)).astype(np.int32) * 7
        prices = rng.integers(0, 4, (B, m)).astype(np.int32) * 7
        eps = np.array([3, 1], np.int32)[:B]
        bigp = np.int32(36)
    A = np.where(mask, vals, neg)
    nvalid = mask.sum(2).astype(np.int32)
    sigma = np.where(rng.random((B, n)) < 0.3, rng.integers(0, m, (B, n)),
                     -1).astype(np.int32)
    return A, nvalid, prices, sigma, eps, bigp


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_dense_bid_plain_matches_reference(dtype):
    rng = np.random.default_rng(0)
    B, n, m = 2, 40, 24
    A, nvalid, prices, sigma, eps, bigp = _dense_rows(rng, B, n, m, dtype)
    t = torch.from_numpy
    ids = torch.arange(B * n, dtype=torch.int32)
    tgt, bid, v1 = dense_bid_plain(ids, t(A), t(nvalid.ravel()),
                                   t(prices.ravel()), t(sigma.ravel()),
                                   t(eps), bigp, with_v1=True)
    rebuilt = 0
    for b in range(B):
        rt, rb = RD._dense_bids(jnp.asarray(A[b]), jnp.asarray(nvalid[b]),
                                jnp.asarray(prices[b]), jnp.asarray(sigma[b]),
                                jnp.asarray(eps[b]), jnp.asarray(bigp))
        rt = np.asarray(rt)
        got = tgt[b * n:(b + 1) * n].numpy()
        np.testing.assert_array_equal(np.where(rt < m, b * m + rt, B * m),
                                      got)
        np.testing.assert_array_equal(_bits(rb),
                                      _bits(bid[b * n:(b + 1) * n]))
        w = A[b] - prices[b][None, :]
        np.testing.assert_array_equal(_bits(w.max(1)),
                                      _bits(v1[b * n:(b + 1) * n]))
        j = w.argmax(1)
        a_star = w[np.arange(n), j] + prices[b][j]
        rebuilt += int((a_star != A[b][np.arange(n), j]).sum())
    assert (nvalid == 0).any() and (nvalid == 1).any() and (nvalid == 2).any()
    if dtype == np.float32:
        assert rebuilt > 0           # (a - p) + p != a does occur
    # a compacted id list with pads: pads give (B * m, 0), the rest as above
    sub = torch.tensor([5, 41, B * n, 2, B * n], dtype=torch.int32)
    st, sb = dense_bid_plain(sub, t(A), t(nvalid.ravel()), t(prices.ravel()),
                             t(sigma.ravel()), t(eps), bigp)
    live = sub < B * n
    np.testing.assert_array_equal(st[live], tgt[sub[live].long()])
    np.testing.assert_array_equal(_bits(sb[live]),
                                  _bits(bid[sub[live].long()]))
    assert (st[~live] == B * m).all() and (sb[~live] == 0).all()
    assert dense_bid(sub, t(A), t(nvalid.ravel()), t(prices.ravel()),
                     t(sigma.ravel()), t(eps), bigp)[0].equal(st)


def _chunk_instances(seed, B, n, integer, density=0.3):
    rng = np.random.default_rng(seed)
    probs = []
    for _ in range(B):
        loc, val, _ = random_sparse_instance(rng, n, n, density,
                                             integer=integer)
        val = val if integer else val.astype(np.float32)
        probs.append(RI.from_coo(loc, val, shape=(n, n), pad_to=n // 2))
    return r_stack(probs)


def _schedule(prob, problem="min"):
    vals, valid = np.asarray(prob.vals), np.asarray(prob.valid)
    vv = vals[valid]
    vmax_abs = float(np.abs(vv).max())
    tr = PA.make_transform(problem, prob.m, vals.dtype, vmax_abs)
    e0, e_min, theta = PA.default_eps_schedule(vals.dtype, vmax_abs, prob.m,
                                               tr.scale)
    bigp = abs(float(tr.sign * tr.scale)) * float(vv.max() - vv.min()) + 1.0
    return vals * np.asarray(tr.sign * tr.scale, vals.dtype), e0, e_min, \
        theta, bigp


@pytest.mark.parametrize("case", [
    dict(integer=True, trunc=0),
    dict(integer=False, trunc=4),
    dict(integer=True, trunc=24, zero_round=True),
    dict(integer=False, trunc=128, zero_round=True),
    dict(integer=True, trunc=4, max_iter=9),
])
def test_solve_chunk_matches_vmapped_reference(case, monkeypatch):
    n, B = 40, 4
    prob = _chunk_instances(1, B, n, case["integer"])
    vals_t, e0, e_min, theta, bigp = _schedule(prob)
    dtype = vals_t.dtype
    max_iter = case.get("max_iter", PA.default_max_iter(n))
    trunc = case["trunc"]
    cols, valid, nvalid = (np.asarray(prob.cols), np.asarray(prob.valid),
                           np.asarray(prob.nvalid))
    ref = RD._solve_chunk_vmapped(
        jnp.asarray(cols), jnp.asarray(vals_t), jnp.asarray(valid),
        jnp.asarray(nvalid), jnp.asarray(e0, dtype), jnp.asarray(e_min, dtype),
        jnp.asarray(theta, dtype), jnp.int32(max_iter),
        jnp.asarray(bigp, dtype), jnp.int32(trunc))
    # record, per scan, whether a lane opened a phase with <= trunc active
    # rows (a phase that makes no round)
    zero_round = []
    scan = PD._unassign_violators

    def spy(A, nvalid_d, prices, owner_buf, sigma, eps_of, bigp_, lanes):
        scan(A, nvalid_d, prices, owner_buf, sigma, eps_of, bigp_, lanes)
        act = ((sigma < 0) & (nvalid_d > 0)).view(B, n).sum(1).numpy()
        zero_round.append(bool((lanes.numpy() & (act <= trunc)).any()))

    monkeypatch.setattr(PD, "_unassign_violators", spy)
    t = torch.from_numpy
    got = PD._solve_chunk(t(cols), t(vals_t), t(valid), t(nvalid), e0, e_min,
                          theta, max_iter, bigp, trunc)
    r_prices, r_sigma, r_rounds, r_phases, r_eps = map(np.asarray, ref)
    np.testing.assert_array_equal(_bits(got[0]), _bits(r_prices))
    np.testing.assert_array_equal(got[1].numpy(), r_sigma)
    np.testing.assert_array_equal(got[2], r_rounds)
    np.testing.assert_array_equal(got[3], r_phases)
    np.testing.assert_array_equal(_bits(got[4]), _bits(r_eps))
    # a lane whose phase makes no round, after rounds in earlier phases
    # (trunc 24), or in every phase (trunc 128 > n)
    assert any(zero_round) == case.get("zero_round", any(zero_round))
    if "max_iter" in case:
        assert (got[2] == max_iter).any()
    elif trunc < 128:
        assert (got[2] > 0).all()


@pytest.mark.parametrize("integer", [True, False])
def test_dense_hybrid_matches_reference_with_prices_and_cache(integer):
    """return_prices, trunc small enough for device rounds, an uneven last
    chunk, then a second call through the same device_cache."""
    n, B = 48, 5
    rng = np.random.default_rng(31)
    locs = [random_sparse_instance(rng, n, n, 0.2, integer=integer)[:2]
            for _ in range(B)]
    mk = lambda I: [I.from_coo(loc, val if integer else  # noqa: E731
                               val.astype(np.float32), shape=(n, n),
                               pad_to=24) for loc, val in locs]
    rprob, pprob = r_stack(mk(RI)), p_stack(mk(PI))
    kw = dict(trunc=6, chunk=2, return_prices=True)
    rs, rm, rp = RD.solve_batched_dense_hybrid(rprob, **kw)
    cache = {}
    for call in range(2):
        ps, pm, pp = PD.solve_batched_dense_hybrid(
            pprob, device="cpu", device_cache=cache, **kw)
        np.testing.assert_array_equal(ps, rs)
        np.testing.assert_array_equal(_bits(pp), _bits(rp))
        for a, b in zip(rm, pm):
            assert set(a) == set(b)
            assert {k: v for k, v in a.items() if k not in TIMERS} == \
                {k: v for k, v in b.items() if k not in TIMERS}
        assert all(mt["soln_found"] for mt in pm)
        assert max(mt["its"] for mt in pm) > 0
        if call == 0:
            csr = cache["dense_csr"]
    assert cache["dense_csr"] is csr
    # the dense block is cached only when the batch is one chunk
    assert "dense_dev" not in cache


def test_dense_hybrid_worker_error_reaches_caller(monkeypatch):
    prob = p_stack([PI.from_coo(*random_sparse_instance(
        np.random.default_rng(2), 24, 24, 0.3)[:2], shape=(24, 24))])

    def boom(*a, **k):
        raise FloatingPointError("device pass failed")

    monkeypatch.setattr(PD, "_solve_dense", boom)
    with pytest.raises(FloatingPointError, match="device pass failed"):
        PD.solve_batched_dense_hybrid(prob, device="cpu")


def test_dense_hybrid_available_rules():
    rng = np.random.default_rng(3)
    loc, val, _ = random_sparse_instance(rng, 20, 20, 0.3)
    sq = PI.from_coo(loc, val, shape=(20, 20))
    assert PD.dense_hybrid_available(sq)
    assert not PD.dense_hybrid_available(PI.from_coo(loc, val,
                                                     shape=(20, 24)))
    assert not PD.dense_hybrid_available(PI.from_coo(loc, val, shape=(20, 20),
                                                     dtype=np.float64))
    assert PD.dense_hybrid_available(sq) == RD.dense_hybrid_available(
        RI.from_coo(loc, val, shape=(20, 20)))
