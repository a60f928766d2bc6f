"""The port's sharded hybrid (sslap_tpu_torch.parallel.sharded_compact)
against the JAX package's (sslap_tpu.parallel.sharded_compact), on the
CPU: CPU meshes of 1, 2 and 4 repeated devices against the reference on
1, 2 and 4 of the eight virtual CPU devices (tests/conftest.py), and on 8
for the reference's own contested instance; the gathered commit's plain
version (ops.commit.commit_plain with a row offset) against a numpy
oracle; ``ThreadGroup.all_gather``.

Tolerance: exact.  sol and prices bit for bit; its, phases, tier_rounds,
ladder_rebuilds, host_bids, obj, final_eps, soln_found and every other
meta key but the timers equal.
"""

import functools
import importlib

import jax
import numpy as np
import pytest
import torch

import sslap_tpu
import sslap_tpu_torch as P
from sslap_tpu import parallel as RP
from sslap_tpu_torch import parallel as PP
from sslap_tpu_torch.parallel import mesh as PM
from sslap_tpu_torch.parallel import sharded_compact as SC
from tests.utils import contested_instance, random_sparse_instance, \
    scipy_sparse_objective

CPU = torch.device("cpu")
PK = importlib.import_module("sslap_tpu_torch.ops.commit")
TIMERS = ("time", "device_time", "host_gs_time")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _ref_mesh(k):
    return RP.make_mesh(devices=jax.devices()[:k])


def _random(n, dens, integer, seed):
    rng = np.random.default_rng(seed)
    loc, val, _ = random_sparse_instance(rng, n, n, dens, integer=integer)
    return loc, (val if integer else val.astype(np.float32))


# name -> (instance, solve kwargs); warm cases start from the reference's
# one-shard cold prices of the instance named in "warm"
INT = _random(96, 0.15, True, 96)
F32 = _random(128, 0.1, False, 17)
# F32's pattern with churned values (the same shapes: one reference
# compile serves both)
CHURN = (F32[0], (F32[1] * np.random.default_rng(18).uniform(
    0.8, 1.25, F32[1].shape)).astype(np.float32))
CASES = {
    "int_min_trunc0": (INT, dict(trunc=0)),
    "int_max_trunc8": (INT, dict(problem="max", trunc=8)),
    "int_min_gs_tail_trunc12": (INT, dict(trunc=12)),
    "int_overlap_trunc4": (INT, dict(trunc=4, overlap=True)),
    "f32_min_trunc16": (F32, dict(trunc=16)),
    "f32_max_overlap_trunc16": (F32, dict(problem="max", trunc=16,
                                          overlap=True)),
    "f32_warm": (F32, dict(trunc=16, warm="f32_min_trunc16")),
    "f32_warm_fr": (CHURN, dict(trunc=16, warm="f32_min_trunc16",
                                warm_fr=2)),
    "int_balance_contested": (contested_instance(256, 64),
                              dict(trunc=0, ladder_balance=True,
                                   balance_floor=2)),
}


def _kwargs(name):
    (loc, val), kw = CASES[name]
    n = int(loc[:, 0].max()) + 1
    kw = dict(kw, loc=loc, val=val, shape=(n, n), cardinality_check=False)
    warm = kw.pop("warm", None)
    if warm is not None:
        kw["warm_prices"] = _reference(warm, 1)["prices"]
    return kw


@functools.lru_cache(maxsize=None)
def _reference(name, shards):
    return RP.auction_solve_sharded_hybrid(mesh=_ref_mesh(shards),
                                           **_kwargs(name))


@functools.lru_cache(maxsize=None)
def _port(name, shards):
    return PP.auction_solve_sharded_hybrid(mesh=PP.make_mesh([CPU] * shards),
                                           **_kwargs(name))


def _assert_same(got, ref):
    np.testing.assert_array_equal(got["sol"], ref["sol"])
    np.testing.assert_array_equal(_bits(got["prices"]), _bits(ref["prices"]))
    gm, rm = got["meta"], ref["meta"]
    assert set(gm) == set(rm)
    for k in rm:
        if k not in TIMERS:
            assert gm[k] == rm[k], (k, gm[k], rm[k])


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_hybrid_matches_reference(name, shards):
    ref = _reference(name, shards)
    got = _port(name, shards)
    _assert_same(got, ref)
    mt = got["meta"]
    assert mt["soln_found"] and mt["n_shards"] == shards
    if name == "int_min_gs_tail_trunc12":
        # the device pass truncated: the host tail did work, and the
        # ladder ran
        assert mt["host_bids"] > 0 and sum(mt["tier_rounds"][2:]) > 0
        loc, val = CASES[name][0]
        assert mt["obj"] == scipy_sparse_objective(loc, val, 96, 96)
    if name == "int_balance_contested" and shards == 4:
        assert mt["ladder_rebuilds"] >= 1
    if "overlap" in name:
        assert mt["overlap"] is True


def test_reference_contested_instance_on_eight_shards():
    """The reference's own spill case (tests/test_sharded_hybrid.py): the
    balanced buffers of eight shards overflow and local rebuilds readmit
    the waiting rows, on both sides the same."""
    loc, val = contested_instance(512, 56)
    kw = dict(loc=loc, val=val, shape=(512, 512), trunc=0,
              cardinality_check=False, ladder_balance=True, balance_floor=8)
    ref = RP.auction_solve_sharded_hybrid(mesh=_ref_mesh(8), **kw)
    got = PP.auction_solve_sharded_hybrid(mesh=PP.make_mesh([CPU] * 8), **kw)
    _assert_same(got, ref)
    assert got["meta"]["ladder_rebuilds"] >= 1
    assert got["meta"]["obj"] == scipy_sparse_objective(loc, val, 512, 512)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_trunc0_equals_the_single_device_tiered_solve(shards):
    """The reference's own invariant: trunc=0 runs every phase to the end
    on the mesh, and the identical tie-breaks reproduce the single-device
    tiered solve (compact.solve_ell_tiered, mode='device') exactly."""
    (loc, val), _ = CASES["int_min_trunc0"]
    single = P.auction_solve(loc=loc, val=val, shape=(96, 96), mode="device",
                             device="cpu", cardinality_check=False)
    sh = _port("int_min_trunc0", shards)
    assert sh["meta"]["tier_rounds"][2] > 0      # the ladder ran
    np.testing.assert_array_equal(sh["sol"], single["sol"])
    assert sh["meta"]["obj"] == single["meta"]["obj"]


@pytest.mark.parametrize("name", ["int_min_gs_tail_trunc12",
                                  "f32_max_overlap_trunc16",
                                  "int_balance_contested"])
def test_replicas_identical_after_every_round(name, monkeypatch):
    """Four shards: after every round (the overlapped regime: once a phase,
    drained) every shard holds the same price and owner bits."""
    seen = {}

    def record(rank, prices, owner):
        seen.setdefault(rank, []).append(
            (prices.numpy().tobytes(), owner.numpy().tobytes()))

    solve = SC.solve_sharded_tiered
    monkeypatch.setattr(SC, "solve_sharded_tiered",
                        lambda *a, **kw: solve(*a, on_round=record, **kw))
    got = PP.auction_solve_sharded_hybrid(mesh=PP.make_mesh([CPU] * 4),
                                          **_kwargs(name))
    mt = got["meta"]
    assert sorted(seen) == [0, 1, 2, 3]
    per_phase = mt["phases"] if mt["overlap"] else 0
    full = mt["tier_rounds"][1] if mt["overlap"] else 0
    assert len(seen[0]) == mt["its"] - full + per_phase
    assert all(seen[r] == seen[0] for r in (1, 2, 3))
    if mt["host_bids"] == 0:        # no host tail: the device's prices
        assert seen[0][-1][0] == got["prices"].tobytes()


def test_solver_mode_matches_reference(monkeypatch):
    """AuctionSolver(mode='sharded_hybrid', device='cpu'): one shard, cold,
    then warm from its prices with warm_mode='fr' (passed through as
    warm_fr=2), against the reference's solver, its default mesh cut to
    one device."""
    from sslap_tpu.parallel import mesh as RM
    make = RM.make_mesh
    monkeypatch.setattr(RM, "make_mesh", lambda devices=None, **kw: make(
        devices=jax.devices()[:1] if devices is None else devices, **kw))
    (loc, val), _ = CASES["f32_min_trunc16"]
    kw = dict(loc=loc, val=val, shape=(128, 128), mode="sharded_hybrid")
    ref = sslap_tpu.AuctionSolver(**kw)
    got = P.AuctionSolver(device="cpu", **kw)
    for warm_mode in ("raw", "fr"):
        r = ref.solve(warm_prices=ref.prices, warm_mode=warm_mode)
        g = got.solve(warm_prices=got.prices, warm_mode=warm_mode)
        _assert_same(g, r)
        assert g["meta"]["mode"] == "sharded_hybrid"
        assert g["meta"]["n_shards"] == 1
    with pytest.raises(ValueError, match="float64"):
        P.AuctionSolver(dtype=np.float64, device="cpu", **kw).solve()


def test_errors_match_reference():
    rng = np.random.default_rng(23)
    rect = rng.integers(1, 9, (8, 12))
    for mod, mesh in ((RP, _ref_mesh(1)), (PP, PP.make_mesh([CPU]))):
        with pytest.raises(ValueError, match="square"):
            mod.auction_solve_sharded_hybrid(rect, mesh=mesh,
                                             cardinality_check=False)
        with pytest.raises(ValueError, match="float64"):
            mod.auction_solve_sharded_hybrid(
                rng.integers(1, 9, (8, 8)), mesh=mesh, dtype=np.float64,
                cardinality_check=False)
    with pytest.raises(P.InfeasibleError):
        PP.auction_solve_sharded_hybrid(loc=np.array([[0, 0], [1, 0]]),
                                        val=np.array([1, 2]), shape=(2, 2),
                                        mesh=PP.make_mesh([CPU]))


def test_ladder_tiers_caps_and_comm_model_match_reference():
    from sslap_tpu.parallel import sharded_compact as RSC
    for n in (64, 96, 1000, 4096, 70_000, 1 << 20, 3_000_000):
        for m in (n, 2 * n):
            for D in (1, 2, 4, 8):
                assert SC.sharded_ladder_tiers(n, m, D) == \
                    RSC.sharded_ladder_tiers(n, m, D)
    assert PP.sharded_ladder_tiers(1 << 20, 1 << 20, 8)[0] == 65536
    for C in (64, 100, 4096, 98_304):
        for n_local in (10, 64, 5000):
            for D in (1, 3, 8):
                for floor in (1, 8, 256):
                    assert SC.balanced_cap(C, n_local, D, floor) == \
                        RSC.balanced_cap(C, n_local, D, floor)
    rng = np.random.default_rng(3)
    tiers = (98_304, 65_536, 128, 64)
    for overlap in (False, True):
        for kw in ({}, {"n_local": 100}, {"cap": lambda c: c // 3}):
            tr = rng.integers(0, 50, 3 + len(tiers) - 1)
            assert SC.comm_bytes_model(tr, tiers, 4096, 4, overlap=overlap,
                                       **kw) == \
                RSC.comm_bytes_model(tr, tiers, 4096, 4, overlap=overlap,
                                     **kw)


def _gathered_commit_oracle(ids, tgt, bid, prices, owner, sigma, off, n_rows):
    """numpy: per column the highest bid, then the lowest global row; the
    winners install, previous owners are evicted; sigma only for rows in
    [off, off + len(sigma))."""
    prices, owner, sigma = prices.copy(), owner.copy(), sigma.copy()
    m = prices.shape[0]
    stay = np.full(ids.shape, n_rows, np.int32)
    evicted = np.full(ids.shape, n_rows, np.int32)
    won = np.zeros(ids.shape, bool)
    for j in np.unique(tgt[tgt < m]):
        at = np.flatnonzero(tgt == j)
        best = bid[at].max()
        w = at[bid[at] == best][np.argmin(ids[at][bid[at] == best])]
        won[w] = True
        prev = owner[j]
        prices[j], owner[j] = bid[w], ids[w]
        if off <= ids[w] < off + sigma.shape[0]:
            sigma[ids[w] - off] = j
        if prev >= 0:
            evicted[w] = prev
            if off <= prev < off + sigma.shape[0]:
                sigma[prev - off] = -1
    lost = (tgt < m) & ~won
    stay[lost] = ids[lost]
    counts = np.array([won.sum(), (evicted < n_rows).sum(), lost.sum()],
                      np.int32)
    return stay, evicted, counts, prices, owner, sigma


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("shard", [0, 2])
def test_gathered_commit_plain_matches_numpy_oracle(dtype, shard):
    """K2's plain version over a gathered set of 4 shards' bids (pads
    included), with ties, winners and evictees of other shards, as shard
    ``shard`` commits it: its replicas as everyone's, sigma only for its
    rows, stay and evicted as global ids padded with n_rows."""
    rng = np.random.default_rng(shard + (dtype == np.int32))
    D, n_local, m, C = 4, 30, 80, 12
    n_rows = D * n_local
    owner = np.full(m, -1, np.int32)
    held = rng.choice(n_rows, 40, replace=False)
    cols = rng.choice(m, 40, replace=False)
    owner[cols] = held
    sig_all = np.full(n_rows, -1, np.int32)
    sig_all[held] = cols
    free = np.setdiff1d(np.arange(n_rows), held)
    ids, tgt = [], []
    for s in range(D):
        mine = np.sort(rng.choice(free[(free >= s * n_local)
                                       & (free < (s + 1) * n_local)],
                                  C - 3, replace=False))
        ids.append(np.concatenate([mine, [n_rows] * 3]))
        tgt.append(np.concatenate([rng.integers(0, 20, C - 4), [m] * 4]))
    ids = np.concatenate(ids).astype(np.int32)
    tgt = np.concatenate(tgt).astype(np.int32)
    bid = (rng.integers(0, 6, ids.shape) * 2).astype(dtype)   # many ties
    prices = rng.integers(0, 5, m).astype(dtype)
    off = shard * n_local
    sigma = sig_all[off:off + n_local]
    want = _gathered_commit_oracle(ids, tgt, bid, prices, owner, sigma, off,
                                   n_rows)
    t = [torch.from_numpy(a.copy()) for a in (prices, owner, sigma)]
    stay, ev, counts = PK.commit(*map(torch.from_numpy, (ids, tgt, bid)), *t,
                                 row_offset=off, n_rows=n_rows)
    for a, b in zip((stay, ev, counts, *t), want):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    assert (want[1] < n_rows).any() and want[0].max() <= n_rows
    # other shards' rows were won and evicted too, and left alone here
    other = (ids < n_rows) & ((ids < off) | (ids >= off + n_local))
    assert (other & (want[0] == n_rows) & (tgt < m)).any()


def test_thread_group_all_gather_in_rank_order():
    def run(rank, group):
        x = torch.arange(2 * 3, dtype=torch.int32).reshape(2, 3) + 10 * rank
        return group.all_gather(rank, x), group.all_gather(
            rank, torch.tensor([rank]))

    for k in (1, 3):
        out = PM.run_spmd(PP.make_mesh([CPU] * k), run)
        want = torch.cat([torch.arange(6, dtype=torch.int32).reshape(2, 3)
                          + 10 * r for r in range(k)])
        for a, b in out:
            assert torch.equal(a, want)
            assert b.tolist() == list(range(k))
