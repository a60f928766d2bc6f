"""The port's distribution layer (sslap_tpu_torch.parallel: partition,
mesh, sharded) against the JAX package's (sslap_tpu.parallel), on the CPU:
CPU meshes of 1, 2 and 4 repeated devices against the reference on 1, 2
and 4 of the eight virtual CPU devices (tests/conftest.py).

Tolerance: exact.  Partitions equal; sigma, rounds, phases and unassigned
counts equal, prices and final eps bit for bit.
"""

import importlib
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec

import sslap_tpu
import sslap_tpu_torch as P
from sslap_tpu import auction as RA
from sslap_tpu import ingest as RI
from sslap_tpu import parallel as RP
from sslap_tpu.parallel import sharded as RS
from sslap_tpu_torch import auction as PA
from sslap_tpu_torch import ingest as PI
from sslap_tpu_torch import parallel as PP
from sslap_tpu_torch.parallel import mesh as PM
from sslap_tpu_torch.parallel import sharded as PS
from tests.utils import random_sparse_instance

CPU = torch.device("cpu")
PK = importlib.import_module("sslap_tpu_torch.ops.commit")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _ref_mesh(k):
    return RP.make_mesh(devices=jax.devices()[:k])


def _skewed(rng, n, m, heavy_rows=4, heavy_nnz=20, light_nnz=2):
    """The first rows carry many entries, the rest a couple (a planted
    matching keeps it feasible)."""
    rr, cc = [], []
    perm = rng.permutation(m)[:n]
    for i in range(n):
        k = heavy_nnz if i < heavy_rows else light_nnz
        cs = set(rng.integers(0, m, k).tolist()) | {int(perm[i])}
        rr.extend([i] * len(cs))
        cc.extend(sorted(cs))
    return np.stack([np.array(rr), np.array(cc)], 1), \
        rng.integers(1, 100, len(rr))


@pytest.mark.parametrize("by", ["rows", "nnz"])
@pytest.mark.parametrize("n,shards", [(37, 4), (40, 8), (5, 2), (16, 1)])
def test_partition_matches_reference(n, shards, by):
    rng = np.random.default_rng(n + shards)
    loc, val = _skewed(rng, n, n + 9)
    r = RI.from_coo(loc, val, shape=(n, n + 9))
    p = PI.from_reference(r)
    rp, rorder = RP.partition_rows(r, shards, by=by)
    pp, porder = PP.partition_rows(p, shards, by=by)
    assert (rorder is None) == (porder is None) == (by == "rows")
    if rorder is not None:
        np.testing.assert_array_equal(porder, rorder)
    for f in ("cols", "vals", "valid", "nvalid"):
        a, b = np.asarray(getattr(rp, f)), getattr(pp, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert (rp.n, rp.m, rp.int_exact) == (pp.n, pp.m, pp.int_exact)
    np.testing.assert_array_equal(PP.shard_nnz_counts(pp, shards),
                                  RP.shard_nnz_counts(rp, shards))
    padded = PP.pad_rows_for_mesh(p, shards)
    ref = RP.pad_rows_for_mesh(r, shards)
    assert padded.n == ref.n and padded.nvalid.tobytes() == \
        np.asarray(ref.nvalid).tobytes()
    assert PP.pad_rows_for_mesh(padded, shards) is padded
    with pytest.raises(ValueError, match="strategy"):
        PP.partition_rows(p, shards, by="cols")


def _case(name):
    """(loc, val, shape, extra kwargs) of one sharded-solve case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "square_f32":
        loc, val, _ = random_sparse_instance(rng, 24, 24, 0.2,
                                             integer=False)
        return loc, val.astype(np.float32), (24, 24), {}
    if name == "square_i32":
        loc, val, _ = random_sparse_instance(rng, 24, 24, 0.2)
        return loc, val, (24, 24), {}
    if name == "rect":
        loc, val, _ = random_sparse_instance(rng, 16, 20, 0.25)
        return loc, val, (16, 20), {}
    if name == "uneven":              # 21 rows over 2 or 4 shards: padding
        loc, val, _ = random_sparse_instance(rng, 21, 23, 0.25,
                                             integer=False)
        return loc, val.astype(np.float32), (21, 23), {"problem": "max"}
    if name == "nnz":
        loc, val = _skewed(rng, 22, 25)
        return loc, val, (22, 25), {"partition": "nnz"}
    if name == "warm":
        loc, val, _ = random_sparse_instance(rng, 20, 20, 0.3)
        cold = sslap_tpu.auction_solve(loc=loc, val=val, shape=(20, 20),
                                       mode="device")
        warm = np.asarray(cold["prices"]) * 0.7
        return loc, val, (20, 20), {"warm_prices": warm.astype(np.int32)}
    raise KeyError(name)


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("name", ["square_f32", "square_i32", "rect",
                                  "uneven", "nnz", "warm"])
def test_sharded_solve_matches_reference(name, shards):
    loc, val, shape, kw = _case(name)
    ref = RP.auction_solve_sharded(loc=loc, val=val, shape=shape,
                                   mesh=_ref_mesh(shards), **kw)
    got = PP.auction_solve_sharded(loc=loc, val=val, shape=shape,
                                   mesh=PP.make_mesh([CPU] * shards), **kw)
    np.testing.assert_array_equal(got["sol"], ref["sol"])
    np.testing.assert_array_equal(_bits(got["prices"]),
                                  _bits(ref["prices"]))
    rm, gm = ref["meta"], got["meta"]
    for k in ("its", "phases", "soln_found", "unassigned", "obj",
              "final_eps", "n_shards", "mode"):
        assert gm[k] == rm[k], k
    assert gm["soln_found"]


def test_sharded_solve_ell_direct_matches_reference():
    """sharded_solve_ell itself, under a round cap that stops it mid-phase
    (rectangular, so the dummies' step runs on every shard)."""
    loc, val, shape, _ = _case("rect")
    r = RI.from_coo(loc, val, shape=shape)
    p = PI.from_reference(r)
    tr = RA.make_transform("min", r.m, np.int32, float(val.max()))
    e0, e_min, theta = RA.default_eps_schedule(np.int32, float(val.max()),
                                               r.m, tr.scale)
    vals_t = np.asarray(tr.apply(r.vals))
    tv = vals_t[np.asarray(r.valid)]
    bigp = float(tv.max() - tv.min()) + 1.0
    for shards in (2, 4):
        rp = RP.pad_rows_for_mesh(r, shards)
        pp = PP.pad_rows_for_mesh(p, shards)
        rvals = np.asarray(tr.apply(rp.vals))
        ref = RS.sharded_solve_ell(rp, jnp.asarray(rvals), _ref_mesh(shards),
                                   jnp.zeros(r.m, jnp.int32), e0, e_min,
                                   theta, 37, bigp, r.n)
        got = PS.sharded_solve_ell(pp, rvals, PP.make_mesh([CPU] * shards),
                                   torch.zeros(r.m, dtype=torch.int32), e0,
                                   e_min, theta, 37, bigp, r.n)
        np.testing.assert_array_equal(got.sigma.numpy(),
                                      np.asarray(ref.sigma))
        np.testing.assert_array_equal(got.prices.numpy(),
                                      np.asarray(ref.prices))
        assert (got.rounds, got.phases, got.unassigned) == \
            (int(ref.rounds), int(ref.phases), int(ref.unassigned))
        assert got.final_eps == np.asarray(ref.final_eps)


def _shard_bids(rng, shards, m, per):
    """Per shard: (tgt, bid, global rows) with equal bids across shards,
    a +0.0 and a -0.0 bid on one column from two shards, a column where
    every shard bids -0.0, and columns with no bid."""
    out = []
    for s in range(shards):
        tgt = rng.integers(0, m - 3, per).astype(np.int32)
        bid = rng.choice(np.float32([-2.5, -1.0, 1.0, 3.0, 7.25]), per)
        rows = (s * 1000 + rng.permutation(1000)[:per]).astype(np.int32)
        tgt[:3] = [m - 3, m - 2, m - 1]
        bid[:3] = [0.0 if s % 2 else -0.0, -0.0, 3.0]
        out.append((tgt, bid.astype(np.float32), rows))
    return out


def _jax_combine(per_shard, m):
    """The reference: resolve_bids on each shard, then its pmax/pmin
    combine under shard_map over the virtual devices."""
    S = len(per_shard)
    bests, winners = [], []
    for tgt, bid, rows in per_shard:
        b, w = RA.resolve_bids(jnp.asarray(tgt), jnp.asarray(bid), m,
                               jnp.asarray(rows))
        bests.append(np.asarray(b))
        winners.append(np.asarray(w))
    combine = RS.make_pmax_combine("rows")
    fn = shard_map(lambda b, w: tuple(x[None] for x in combine(b[0], w[0])),
                   mesh=_ref_mesh(S),
                   in_specs=(PartitionSpec("rows"),) * 2,
                   out_specs=(PartitionSpec("rows"),) * 2)
    b, w = jax.jit(fn)(jnp.asarray(np.stack(bests)),
                       jnp.asarray(np.stack(winners)))
    return np.asarray(b)[0], np.asarray(w)[0]


@pytest.mark.parametrize("shards", [2, 3])
def test_key_combine_equals_pmax_pmin_combine(shards):
    rng = np.random.default_rng(shards)
    m = 40
    per_shard = _shard_bids(rng, shards, m, 24)
    want_best, want_winner = _jax_combine(per_shard, m)

    def run(rank, group):
        tgt, bid, rows = map(torch.from_numpy, per_shard[rank])
        best, winner = PA.resolve_bids(tgt, bid, m, rows)
        return PS.make_pmax_combine(group, rank)(best, winner)

    results = PM.run_spmd(PP.make_mesh([CPU] * shards), run)
    for best, winner in results:          # every replica the same
        np.testing.assert_array_equal(_bits(best.numpy()), _bits(want_best))
        np.testing.assert_array_equal(winner.numpy(), want_winner)
    def run_keys(rank, group):
        tgt, bid, rows = per_shard[rank]
        keys = torch.zeros(m, dtype=torch.int64)
        PK.resolve_plain(*map(torch.from_numpy, (rows, tgt, bid)), keys)
        return PS.make_pmax_combine(group, rank).keys(keys)

    tables = PM.run_spmd(PP.make_mesh([CPU] * shards), run_keys)
    assert all(torch.equal(t, tables[0]) for t in tables)
    best, winner = PK.decode_keys(tables[0], torch.float32)
    np.testing.assert_array_equal(winner.numpy(), want_winner)
    # bit for bit, but where the reference's combined best is -0.0: the
    # keys canonicalise zero, which decodes as +0.0 (a solve never bids
    # -0.0: a* is canonicalised and eps >= 0, so its prices agree)
    neg0 = (want_best == 0) & np.signbit(want_best)
    assert neg0[m - 3] and neg0[m - 2]     # the rank-0 shard bid -0.0
    assert (best.numpy()[neg0] == 0).all() and \
        not torch.signbit(best[torch.from_numpy(neg0)]).any()
    np.testing.assert_array_equal(_bits(best.numpy())[~neg0],
                                  _bits(want_best)[~neg0])


def test_replicas_identical_after_every_round(monkeypatch):
    """Four shards, rectangular and warm-started (the owner replicas
    diverge in each violator scan until combine_owner): after every
    commit and every dummy step all shards hold the same prices and
    owner bits, and the scan's re-converged owners agree too."""
    loc, val, shape, _ = _case("rect")
    cold = sslap_tpu.auction_solve(loc=loc, val=val, shape=shape,
                                   mode="device")
    seen = {}

    def record(what, prices, owner):
        name = threading.current_thread().name
        seen.setdefault(name, []).append(
            (what, prices.numpy().tobytes(), owner.numpy().tobytes()))

    commit_bids, grab = PA.commit_bids, PA.dummy_grab_step
    unassign = PA.unassign_violators

    def commit_spy(*a, **kw):
        out = commit_bids(*a, **kw)
        record("commit", out[0], out[1])
        return out

    def grab_spy(*a, **kw):
        out = grab(*a, **kw)
        record("dummy", out[0], out[1])
        return out

    def unassign_spy(cols, vals_t, valid, prices, owner, *a, **kw):
        out = unassign(cols, vals_t, valid, prices, owner, *a, **kw)
        record("scan", prices, owner)
        return out

    monkeypatch.setattr(PA, "commit_bids", commit_spy)
    monkeypatch.setattr(PA, "dummy_grab_step", grab_spy)
    monkeypatch.setattr(PA, "unassign_violators", unassign_spy)
    warm = (np.asarray(cold["prices"]) * 0.5).astype(np.int32)
    got = PP.auction_solve_sharded(loc=loc, val=val, shape=shape,
                                   mesh=PP.make_mesh([CPU] * 4),
                                   warm_prices=warm)
    ref = RP.auction_solve_sharded(loc=loc, val=val, shape=shape,
                                   mesh=_ref_mesh(4), warm_prices=warm)
    np.testing.assert_array_equal(got["sol"], ref["sol"])
    assert len(seen) == 4
    logs = list(seen.values())
    kinds = [w for w, _, _ in logs[0]]
    assert kinds.count("commit") == got["meta"]["its"]
    assert kinds.count("dummy") == got["meta"]["its"]
    assert kinds.count("scan") == got["meta"]["phases"] - 1 > 0
    for log in logs[1:]:
        assert log == logs[0]


def test_solver_mode_sharded_matches_reference():
    rng = np.random.default_rng(31)
    loc, val, _ = random_sparse_instance(rng, 30, 30, 0.2, integer=False)
    val = val.astype(np.float32)
    ref = sslap_tpu.AuctionSolver(loc=loc, val=val, shape=(30, 30),
                                  mode="sharded")
    got = P.AuctionSolver(loc=loc, val=val, shape=(30, 30), mode="sharded",
                          device="cpu")
    for _ in range(2):          # cold, then warm from the last prices
        r = ref.solve(warm_prices=ref.prices)
        g = got.solve(warm_prices=got.prices)
        np.testing.assert_array_equal(g["sol"], r["sol"])
        np.testing.assert_array_equal(_bits(g["prices"]),
                                      _bits(r["prices"]))
        assert g["meta"]["its"] == r["meta"]["its"]
        assert g["meta"]["n_shards"] == 1 and g["meta"]["mode"] == "sharded"
    with pytest.warns(UserWarning, match="warm_mode='fr'"):
        got.solve(warm_prices=got.prices, warm_mode="fr")
    with pytest.raises(ValueError, match="float64"):
        P.AuctionSolver(loc=loc, val=val, shape=(30, 30), mode="sharded",
                        dtype=np.float64, device="cpu").solve()


def test_identity_combine_equals_the_unsharded_solve():
    """The injection points on one 'shard' (solve_ell's combine,
    count_unassigned and combine_owner, as the reference's own fake-combine
    test): identity hooks give the unsharded result, and on_round sees
    every round."""
    rng = np.random.default_rng(4)
    C = rng.integers(0, 50, (16, 16))
    prob = PI.from_dense(C)
    tr = PA.make_transform("min", prob.m, np.int32, float(C.max()))
    args = [torch.from_numpy(a) for a in (prob.cols, tr.apply(prob.vals),
                                          prob.valid, prob.nvalid)]
    calls, rounds = [], []

    def fake_keys(keys):
        calls.append(1)
        return keys

    res = PA.solve_ell(*args, torch.zeros(prob.m, dtype=torch.int32), 100,
                       1, 5, 10_000,
                       combine=types.SimpleNamespace(keys=fake_keys),
                       count_unassigned=lambda s: PA.count_unassigned_rows(
                           s, args[3]),
                       combine_owner=lambda o: o,
                       on_round=lambda r, left, eps: rounds.append(r))
    base = PA.solve_ell(*args, torch.zeros(prob.m, dtype=torch.int32), 100,
                        1, 5, 10_000)
    assert len(calls) == res.rounds == len(rounds) == base.rounds
    assert rounds == list(range(1, res.rounds + 1))
    assert torch.equal(res.sigma, base.sigma)
    assert torch.equal(res.prices, base.prices)


def test_mesh_helpers_and_unported_parts(monkeypatch):
    mesh = PP.make_mesh([CPU] * 3, axis_name="batch")
    assert mesh.shape == {"batch": 3} and mesh.axis_names == ("batch",)
    assert mesh.devices == [CPU] * 3
    with pytest.raises(ValueError):
        PP.Mesh([])
    assert mesh.processes == [0] * 3 and not mesh.spans_processes
    assert mesh.local_ranks() == [0, 1, 2]
    x = torch.arange(4)
    assert PM.put_global(x, mesh) is x
    assert PM.put_global_args(mesh, (None, "rows"), (x, 5)) == (x, 5)
    np.testing.assert_array_equal(PM.fetch_global(x), np.arange(4))
    # with nothing given and no group named by the environment: a no-op
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert PP.initialize_multihost() is None
    assert not torch.distributed.is_initialized()
    assert PM.process_count() == 1 and PM.process_index() == 0
    rng = np.random.default_rng(5)
    loc, val, _ = random_sparse_instance(rng, 10, 10, 0.3)
    plain = PP.auction_solve_sharded(loc=loc, val=val, shape=(10, 10),
                                     mesh=mesh, axis_name="batch")
    timed = PP.auction_solve_sharded(loc=loc, val=val, shape=(10, 10),
                                     mesh=mesh, axis_name="batch",
                                     instrument=True)
    np.testing.assert_array_equal(timed["sol"], plain["sol"])
    for k in ("round_s", "compute_s", "comm_s", "comm_fraction"):
        assert np.isfinite(timed["meta"][k]) and timed["meta"][k] >= 0
    assert timed["meta"]["n_shards"] == 3
    with pytest.raises(ValueError, match="float64"):
        PP.auction_solve_sharded(loc=loc, val=val, shape=(10, 10),
                                 mesh=mesh, dtype=np.float64)
    with pytest.raises(P.InfeasibleError):
        PP.auction_solve_sharded(loc=np.array([[0, 0], [1, 0]]),
                                 val=np.array([1, 2]), shape=(2, 2),
                                 mesh=mesh)


def test_a_failing_shard_raises_its_error():
    """A shard that raises ends the group: the others leave their
    collective, and the caller gets the shard's own error."""
    def run(rank, group):
        group.all_reduce(rank, torch.zeros(2), torch.add)
        if rank == 1:
            raise KeyError("shard 1")
        group.all_reduce(rank, torch.zeros(2), torch.add)

    for _ in range(5):
        with pytest.raises(KeyError, match="shard 1"):
            PM.run_spmd(PP.make_mesh([CPU] * 3), run)

    def total(rank, group):
        return group.all_reduce(rank, torch.tensor([rank + 1]),
                                torch.add).item()

    assert PM.run_spmd(PP.make_mesh([CPU] * 4), total) == [10] * 4
