"""The port's candidate-list engine (sslap_tpu_torch.candidate) against the
JAX package's (sslap_tpu.candidate), on the CPU, where K1 and K2 run
their plain versions.

Tolerance: exact.  Shortlists, targets, sigma, owner, the id buffers and
every count equal; values, bids and prices bit for bit (float32 compared
as int32 bits, so -0.0 and +0.0 differ).  The instances are made from a
seed with numpy and hold exact zeros, ties and -0.0 in the transformed
values on purpose.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from sslap_tpu import auction as RA
from sslap_tpu import candidate as RCD
from sslap_tpu import compact as RC
from sslap_tpu import ingest as RI
from sslap_tpu_torch import candidate as PCD
from sslap_tpu_torch.auction import neg_sentinel

DTYPES = {"float32": (np.float32, torch.float32, jnp.float32),
          "int32": (np.int32, torch.int32, jnp.int32)}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(r, p, what):
    r, p = np.asarray(r), p.numpy() if isinstance(p, torch.Tensor) \
        else np.asarray(p)
    assert r.shape == p.shape, what
    np.testing.assert_array_equal(_bits(p), _bits(r), err_msg=what)


def _w_table(rng, C, K, np_dt):
    """Tie-heavy w rows: values from a few levels, +-0.0 among them, the
    neg sentinel on padded slots (rows with 0, 1 and all entries)."""
    neg = neg_sentinel(np.dtype(np_dt))
    levels = np.array([-3, -1, 0, 0, 2, 2, 5], np.int64)
    w = levels[rng.integers(0, len(levels), (C, K))].astype(np_dt)
    if np_dt == np.float32:
        w = np.where(rng.random((C, K)) < 0.3, -w, w).astype(np_dt)
    nv = rng.integers(0, K + 1, C)
    nv[:4] = [0, 1, min(2, K), K]
    pad = np.arange(K)[None, :] >= nv[:, None]
    return np.where(pad, neg, w).astype(np_dt), nv.astype(np.int32)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("K,kappa", [(1, 1), (1, 4), (3, 4), (8, 1),
                                     (8, 4), (8, 32), (40, 32)])
def test_topk_shortlist_matches_reference(dt, K, kappa):
    np_dt, _, j_dt = DTYPES[dt]
    rng = np.random.default_rng(K * 100 + kappa)
    C = 64
    w, _ = _w_table(rng, C, K, np_dt)
    cols = np.sort(rng.permutation(4 * K + 8)[:K])[None, :].repeat(C, 0)
    cols = cols.astype(np.int32)
    # a's: w itself (its -0.0 kept) or w + 1, the padding left as it is
    vals = np.where((rng.random((C, K)) < 0.5) | (w == w.min()), w,
                    w + np_dt(1)).astype(np_dt)
    bigp = np_dt(7)
    ref = jax.jit(RCD._topk_shortlist, static_argnums=3)(
        jnp.asarray(w), jnp.asarray(cols), jnp.asarray(vals), kappa,
        jnp.asarray(bigp, j_dt))
    got = PCD._topk_shortlist(_t(w), _t(cols), _t(vals), kappa, bigp)
    for name, r, p in zip(("sc_cols", "sc_vals", "tau", "v1", "v2", "jstar",
                           "a_star"), ref, got):
        _same(r, p, name)


def _scpack_rows(rng, C, kappa, m, np_dt):
    """Shortlist rows as a rescan leaves them, and then some: ascending
    and tied values, empty slots (neg), tau of neg, -0.0 or a value."""
    neg = neg_sentinel(np.dtype(np_dt))
    sc_cols = np.stack([rng.permutation(m)[:kappa] for _ in range(C)])
    levels = np.array([0, 0, 1, 3, 3, 6], np.int64)
    sc_vals = levels[rng.integers(0, len(levels), (C, kappa))].astype(np_dt)
    n_real = rng.integers(0, kappa + 1, C)
    empty = np.arange(kappa)[None, :] >= n_real[:, None]
    sc_cols = np.where(empty, 0, sc_cols).astype(np.int32)
    if np_dt == np.float32:       # a K = 1 rescan leaves -0.0 values
        sc_vals = np.where(rng.random((C, kappa)) < 0.5, -sc_vals, sc_vals)
    sc_vals = np.where(empty, neg, sc_vals).astype(np_dt)
    tau = np.where(rng.random(C) < 0.3, neg,
                   rng.integers(-2, 3, C)).astype(np_dt)
    if np_dt == np.float32:
        tau = np.where(tau == 0, np.float32(-0.0), tau).astype(np_dt)
    nv = np.maximum(n_real + rng.integers(0, 3, C), 0).astype(np.int32)
    return sc_cols, sc_vals, tau, nv


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("kappa", [1, 4, 32])
@pytest.mark.parametrize("phase_start", [False, True])
def test_fast_bids_match_reference(dt, kappa, phase_start):
    np_dt, torch_dt, j_dt = DTYPES[dt]
    rng = np.random.default_rng(kappa + 7 * phase_start)
    C, m = 96, 80
    sc_cols, sc_vals, tau, nv = _scpack_rows(rng, C, kappa, m, np_dt)
    prices = rng.integers(0, 3, m).astype(np_dt)
    sig = np.where(rng.random(C) < 0.5, -1,
                   np.where(rng.random(C) < 0.5, sc_cols[:, 0],
                            rng.integers(0, m, C))).astype(np.int32)
    live = rng.random(C) < 0.8
    eps, bigp = np_dt(1), np_dt(9)
    rpack = RCD.build_scpack(jnp.asarray(sc_cols), jnp.asarray(sc_vals),
                             jnp.asarray(tau), jnp.asarray(nv), kappa)
    ppack = PCD.build_scpack(_t(sc_cols), _t(sc_vals), _t(tau), _t(nv), kappa)
    _same(rpack, ppack, "scpack")
    ref = jax.jit(RCD._fast_bids, static_argnums=(6, 7, 8, 9))(
        rpack, jnp.asarray(prices), jnp.asarray(sig), jnp.asarray(live),
        jnp.asarray(eps, j_dt), jnp.asarray(bigp, j_dt), kappa, j_dt, m,
        phase_start)
    got = PCD._fast_bids(ppack, _t(prices), _t(sig), _t(live), eps, bigp,
                         kappa, torch_dt, m, phase_start)
    tgt_r, tgt_p = np.asarray(ref[0]), got[0].numpy()
    np.testing.assert_array_equal(tgt_p, tgt_r)
    bidding = tgt_r < m
    _same(np.asarray(ref[1])[bidding], got[1].numpy()[bidding], "bid")
    _same(ref[2], got[2], "uncertified")
    _same(ref[3], got[3], "violators")


def test_fast_bid_tie_breaks_lowest_column():
    """The reference's case (``tests/test_r3_fixes.py``): slots in
    build-time order (column 7 first), both tied at bid time: the bid goes
    to column 3."""
    kappa = 2
    pack = PCD.build_scpack(
        torch.tensor([[7, 3]], dtype=torch.int32),
        torch.tensor([[5.0, 5.0]]),
        torch.full((1,), neg_sentinel(torch.float32)),
        torch.tensor([2], dtype=torch.int32), kappa)
    tgt, _, uncert, _ = PCD._fast_bids(
        pack, torch.zeros(16), torch.full((1,), -1, dtype=torch.int32),
        torch.ones(1, dtype=torch.bool), 0.5, 10.0, kappa, torch.float32,
        16, False)
    assert int(tgt[0]) == 3 and not bool(uncert[0])


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_build_scpack_round_trips(dt):
    np_dt, torch_dt, _ = DTYPES[dt]
    rng = np.random.default_rng(3)
    kappa = 4
    sc_cols, sc_vals, tau, nv = _scpack_rows(rng, 50, kappa, 30, np_dt)
    pack = PCD.build_scpack(_t(sc_cols), _t(sc_vals), _t(tau), _t(nv), kappa)
    assert pack.dtype == torch.int32 and pack.shape == (50, 2 * kappa + 2)
    _same(sc_cols, pack[:, :kappa], "cols")
    _same(sc_vals, PCD._bits_to(pack[:, kappa:2 * kappa], torch_dt), "vals")
    _same(tau, PCD._bits_to(pack[:, 2 * kappa], torch_dt), "tau")
    _same(nv, pack[:, 2 * kappa + 1], "nvalid")


# ---------------------------------------------------------------------------
# Rounds and whole solves
# ---------------------------------------------------------------------------


def _instance(n, integer, seed=0, k=8, hot=256, skew=1000):
    """k random columns a row plus a planted permutation, and 6 entries a
    row on ``hot`` popular columns that cost ``skew`` less than the rest:
    most rows fight over the popular columns, so at n > 4096 the ladder's
    top tier runs candidate rounds with rescans.  Costs start at 0 (so the
    min transform makes -0.0), float32 in steps of 0.5."""
    rng = np.random.default_rng(seed)
    rr = np.concatenate([np.repeat(np.arange(n), k), np.arange(n),
                         np.repeat(np.arange(n), 6)])
    cc = np.concatenate([rng.integers(0, n, n * k), rng.permutation(n),
                         rng.integers(0, hot, 6 * n) * 7])
    _, idx = np.unique(rr * n + cc, return_index=True)
    rr, cc = rr[idx], cc[idx]
    base = np.where((cc % 7 == 0) & (cc < hot * 7), 0, skew)
    step = rng.integers(0, 100, rr.shape[0])
    val = (step + base) if integer else (step * 0.5 + base).astype(
        np.float32)
    prob = RI.from_coo(np.stack([rr, cc], 1), val, shape=(n, n),
                       dtype=np.int32 if integer else np.float32)
    vals, valid = np.asarray(prob.vals), np.asarray(prob.valid)
    vmax = float(np.abs(vals[valid]).max())
    tr = RA.make_transform("min", n, vals.dtype, vmax)
    e0, e_min, theta = RA.default_eps_schedule(vals.dtype, vmax, n, tr.scale)
    return dict(cols=np.asarray(prob.cols), vals_t=np.asarray(
        tr.apply(prob.vals)), valid=valid, nvalid=np.asarray(prob.nvalid),
        e0=e0, e_min=e_min, theta=theta, n=n,
        max_iter=RA.default_max_iter(n))


@pytest.fixture(scope="module")
def round_cases():
    """Mid-solve states on a 300-row instance: prices raised, a partial
    matching, shortlists rebuilt at lower prices, ids and backlog disjoint
    sets of rows (ascending, padded with n) -- for each dtype."""
    out = {}
    for dt in sorted(DTYPES):
        np_dt, _, j_dt = DTYPES[dt]
        inst = _instance(300, dt == "int32", seed=5, hot=40)
        n = inst["n"]
        rng = np.random.default_rng(11)
        vals_m = np.where(inst["valid"], inst["vals_t"],
                          neg_sentinel(np.dtype(np_dt))).astype(np_dt)
        prices = rng.integers(0, 4, n).astype(np_dt) * np_dt(
            max(int(inst["e0"]) // 3, 1))
        # a partial matching on each row's first valid column
        sigma = np.full(n, -1, np.int32)
        owner = np.full(n, -1, np.int32)
        for r in rng.permutation(n)[:n // 2]:
            c = int(inst["cols"][r, 0])
            if owner[c] < 0:
                owner[c], sigma[r] = r, c
        w_old = vals_m - (prices // 2 if dt == "int32" else prices * np_dt(
            0.5))[inst["cols"]]
        kappa = 4
        sc = RCD._topk_shortlist(jnp.asarray(w_old),
                                 jnp.asarray(inst["cols"]),
                                 jnp.asarray(vals_m), kappa,
                                 jnp.asarray(7, j_dt))
        out[dt] = dict(inst=inst, vals_m=vals_m, prices=prices, sigma=sigma,
                       owner=owner, sc_cols=np.asarray(sc[0]),
                       sc_vals=np.asarray(sc[1]), sc_tau=np.asarray(sc[2]),
                       kappa=kappa, rng_seed=17)
    return out


def _buffers(case, phase_start, C, B, live_ids, live_back):
    n = case["inst"]["n"]
    rng = np.random.default_rng(case["rng_seed"] + phase_start)
    un = np.flatnonzero(case["sigma"] < 0)
    pool = np.arange(n) if phase_start else un
    pool = pool[case["inst"]["nvalid"][pool] > 0]
    pick = rng.permutation(pool)[:live_ids + live_back]
    ids = np.full(C, n, np.int32)
    ids[:live_ids] = np.sort(pick[:live_ids])
    back = np.full(B, n, np.int32)
    back[:live_back] = np.sort(pick[live_ids:])
    return ids, back


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("phase_start", [False, True])
@pytest.mark.parametrize("resc_cap,live_back", [(32, 60), (64, 20),
                                                (32, 0)])
def test_candidate_round_matches_reference(round_cases, dt, phase_start,
                                           resc_cap, live_back):
    """One round from a mid-solve state: resc_cap below the backlog's
    live rows, above them, and an empty backlog (the skipped rescan);
    pads in both buffers."""
    case = round_cases[dt]
    inst = case["inst"]
    n, kappa = inst["n"], case["kappa"]
    ids, back = _buffers(case, phase_start, 96, 128, 70, live_back)
    bigp, eps = 37, 3
    rpack = RC.build_rowpack(jnp.asarray(inst["cols"]),
                             jnp.asarray(case["vals_m"]),
                             jnp.asarray(inst["nvalid"]))
    scr = RCD.build_scpack(jnp.asarray(case["sc_cols"]),
                           jnp.asarray(case["sc_vals"]),
                           jnp.asarray(case["sc_tau"]),
                           jnp.asarray(inst["nvalid"]), kappa)
    j_dt = DTYPES[dt][2]
    fn = jax.jit(lambda *a: RCD.candidate_round(
        *a, kappa=kappa, resc_cap=resc_cap, phase_start=phase_start))
    ref = fn(rpack, scr, jnp.asarray(case["prices"]),
             jnp.asarray(case["owner"]), jnp.asarray(case["sigma"]),
             jnp.asarray(ids), jnp.asarray(back), jnp.asarray(eps, j_dt),
             jnp.asarray(bigp, j_dt))
    scp = PCD.build_scpack(_t(case["sc_cols"]), _t(case["sc_vals"]),
                           _t(case["sc_tau"]), _t(inst["nvalid"]), kappa)
    got = PCD.candidate_round(
        _t(inst["cols"]), _t(case["vals_m"]), _t(inst["nvalid"]), scp,
        _t(case["prices"]), _t(case["owner"]), _t(case["sigma"]), _t(ids),
        _t(back), eps, bigp, kappa=kappa, resc_cap=resc_cap,
        phase_start=phase_start)
    for name, r, p in zip(("scpack", "prices", "owner", "sigma", "new_ids",
                           "new_backlog", "n_won", "n_evicted",
                           "n_rescanned"), ref, got):
        _same(r, p, name)
    assert int(ref[8]) == min(resc_cap, live_back)


def _ref_solve(inst, p0, **kw):
    return jax.jit(lambda *a: RCD.solve_ell_candidates(
        *a, inst["e0"], inst["e_min"], inst["theta"], inst["max_iter"],
        **kw))(inst["cols"], inst["vals_t"], inst["valid"], inst["nvalid"],
               jnp.asarray(p0))


def _port_solve(inst, p0, **kw):
    return PCD.solve_ell_candidates(
        _t(inst["cols"]), _t(inst["vals_t"]), _t(inst["valid"]),
        _t(inst["nvalid"]), _t(p0), inst["e0"], inst["e_min"],
        inst["theta"], inst["max_iter"], **kw)


def _same_solve(ref, got):
    (rr, rs), (pr, ps) = ref, got
    _same(rr.sigma, pr.sigma, "sigma")
    _same(rr.prices, pr.prices, "prices")
    _same(rs.owner, ps.owner, "owner")
    _same(rs.sc_cols, ps.sc_cols, "sc_cols")
    _same(rs.sc_vals, ps.sc_vals, "sc_vals")
    _same(rs.sc_tau, ps.sc_tau, "sc_tau")
    _same(rr.final_eps, np.asarray(pr.final_eps), "final_eps")
    assert int(rr.rounds) == pr.rounds
    assert int(rr.phases) == pr.phases
    assert int(rr.unassigned) == pr.unassigned
    assert int(rs.rescans) == ps.rescans
    assert np.asarray(rs.tier_rounds).tolist() == ps.tier_rounds


@pytest.fixture(scope="module")
def solves():
    """The n = 5000 instances (above the 4096 switch) and the reference's
    cold solve of each, shared by the cold and warm cases."""
    out = {}
    for dt in sorted(DTYPES):
        inst = _instance(5000, dt == "int32")
        p0 = np.zeros(inst["n"], DTYPES[dt][0])
        out[dt] = (inst, p0, _ref_solve(inst, p0))
    return out


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_solve_matches_reference_with_candidate_rounds(solves, dt):
    """Cold and complete at n = 5000: the top tier runs candidate rounds
    (tier_rounds[1] > 0) that rescan beyond the phase starts' full
    rescans."""
    inst, p0, ref = solves[dt]
    got = _port_solve(inst, p0)
    _same_solve(ref, got)
    res, st = got
    n = inst["n"]
    assert st.tier_rounds[1] > 0
    assert st.rescans > n
    assert st.rescans > n * st.phases      # rescans inside the ladder too
    assert res.unassigned == 0


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_warm_truncated_solve_matches_reference(solves, dt):
    """Warm p0 (the cold solve's prices, relaxed) and trunc > 0."""
    inst, _, (rr, _) = solves[dt]
    p = np.asarray(rr.prices)
    p0 = (p // 2 if dt == "int32" else p * np.float32(0.75)).astype(p.dtype)
    _same_solve(_ref_solve(inst, p0, trunc=64), _port_solve(inst, p0,
                                                             trunc=64))
