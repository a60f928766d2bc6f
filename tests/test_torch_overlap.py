"""The port's overlapped row-sharded solve (sslap_tpu_torch.parallel.overlap)
against the JAX package's (sslap_tpu.parallel.overlap), on the CPU: CPU
meshes of 1, 2 and 4 repeated devices against the reference on 1, 2 and
4 of the eight virtual CPU devices (tests/conftest.py); and the fused key
commit's plain version (ops.commit.commit_keys_plain) against the commit
it replaces on every round of the sharded and overlapped solves.

Tolerance: exact.  sigma, rounds, phases and unassigned equal; prices and
final eps bit for bit.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax, shard_map
from jax.sharding import PartitionSpec

import sslap_tpu
import sslap_tpu_torch as P
from sslap_tpu import auction as RA
from sslap_tpu import ingest as RI
from sslap_tpu import parallel as RP
from sslap_tpu.parallel import overlap as RO
from sslap_tpu_torch import auction as PA
from sslap_tpu_torch import parallel as PP
from sslap_tpu_torch.parallel import mesh as PM
from sslap_tpu_torch.parallel import overlap as PO
from tests.utils import random_sparse_instance

CPU = torch.device("cpu")
PK = importlib.import_module("sslap_tpu_torch.ops.commit")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _ref_mesh(k):
    return RP.make_mesh(devices=jax.devices()[:k])


def _instance(n, integer, seed=None):
    rng = np.random.default_rng(n * 2 + integer if seed is None else seed)
    loc, val, _ = random_sparse_instance(rng, n, n, 0.15, integer=integer)
    return loc, (val if integer else val.astype(np.float32))


# (n, integer costs, problem, warm start): every combination of n, cost
# kind and problem, cold or warm
CASES = [(32, True, "min", False), (32, False, "max", False),
         (32, True, "max", True), (32, False, "min", True),
         (96, True, "min", True), (96, False, "min", False),
         (96, True, "max", False), (96, False, "max", True)]


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("n,integer,problem,warm", CASES)
def test_overlapped_solve_matches_reference(n, integer, problem, warm,
                                            shards):
    loc, val = _instance(n, integer)
    kw = dict(loc=loc, val=val, shape=(n, n), problem=problem,
              cardinality_check=False)
    if warm:
        cold = RP.auction_solve_overlapped(mesh=_ref_mesh(1), **kw)
        kw["warm_prices"] = (np.asarray(cold["prices"]) * 0.5).astype(
            val.dtype)
    ref = RP.auction_solve_overlapped(mesh=_ref_mesh(shards), **kw)
    got = PP.auction_solve_overlapped(mesh=PP.make_mesh([CPU] * shards),
                                      **kw)
    np.testing.assert_array_equal(got["sol"], ref["sol"])
    np.testing.assert_array_equal(_bits(got["prices"]), _bits(ref["prices"]))
    rm, gm = ref["meta"], got["meta"]
    assert set(gm) == set(rm)
    for k in ("its", "phases", "soln_found", "unassigned", "obj",
              "final_eps", "n_shards", "mode", "overlap"):
        assert gm[k] == rm[k], k
    assert gm["soln_found"]


def _phase_inputs(n, shards):
    """An instance's transformed values, warm prices (half the optimum's)
    and its eps schedule's first eps, for one phase."""
    loc, val = _instance(n, True, seed=77)
    r = RI.from_coo(loc, val, shape=(n, n))
    r = RP.pad_rows_for_mesh(r, shards)
    tr = RA.make_transform("min", n, np.int32, float(val.max()))
    e0, _, _ = RA.default_eps_schedule(np.int32, float(val.max()), n,
                                       tr.scale)
    vals_t = np.asarray(tr.apply(r.vals))
    tv = vals_t[np.asarray(r.valid)]
    cold = sslap_tpu.auction_solve(loc=loc, val=val, shape=(n, n),
                                   mode="device")
    p0 = (np.asarray(cold["prices"]) // 2).astype(np.int32)
    return (np.asarray(r.cols), vals_t, np.asarray(r.valid),
            np.asarray(r.nvalid), p0, np.int32(e0),
            np.int32(tv.max() - tv.min() + 1))


@pytest.mark.parametrize("max_rounds", [7, 10_000])
@pytest.mark.parametrize("shards", [1, 3])
def test_overlapped_phase_matches_reference(shards, max_rounds):
    """overlapped_phase itself: one phase from warm prices, under a round
    cap that stops it with bids pending and without one."""
    cols, vals_t, valid, nvalid, p0, eps, bigp = _phase_inputs(45, shards)
    n, m = cols.shape[0], p0.shape[0]
    n_local = n // shards

    def ref_run(c, v, ok, nv, p):
        off = lax.axis_index("rows").astype(jnp.int32) * n_local
        owner = jnp.full((m,), -1, jnp.int32)
        sigma = jnp.full((n_local,), -1, jnp.int32)
        pr, ow, sg, r = RO.overlapped_phase(
            c, v, ok, nv, p, owner, sigma, jnp.int32(eps), jnp.int32(bigp),
            off, "rows", jnp.int32(max_rounds))
        return pr[None], ow[None], sg, r[None]

    rows = PartitionSpec("rows")
    fn = shard_map(ref_run, mesh=_ref_mesh(shards),
                   in_specs=(rows,) * 4 + (PartitionSpec(),),
                   out_specs=(rows,) * 4, check_vma=False)
    r_prices, r_owner, r_sigma, r_rounds = (np.asarray(x) for x in jax.jit(
        fn)(*map(jnp.asarray, (cols, vals_t, valid, nvalid, p0))))

    def run(rank, group):
        sl = slice(rank * n_local, (rank + 1) * n_local)
        t = lambda a: torch.from_numpy(a[sl].copy())  # noqa: E731
        return PO.overlapped_phase(
            t(cols), t(vals_t), t(valid), t(nvalid.astype(np.int32)),
            torch.from_numpy(p0.copy()), torch.full((m,), -1,
                                                    dtype=torch.int32),
            torch.full((n_local,), -1, dtype=torch.int32), eps, bigp,
            rank * n_local, group, rank, max_rounds)

    got = PM.run_spmd(PP.make_mesh([CPU] * shards), run)
    assert [g[3] for g in got] == list(r_rounds)
    if max_rounds == 7:
        assert got[0][3] == 7
    for s, (prices, owner, _, _) in enumerate(got):
        np.testing.assert_array_equal(prices.numpy(), r_prices[s])
        np.testing.assert_array_equal(owner.numpy(), r_owner[s])
    np.testing.assert_array_equal(
        np.concatenate([g[2].numpy() for g in got]), r_sigma)


def test_solver_mode_overlapped_matches_reference():
    loc, val = _instance(40, False, seed=31)
    ref = sslap_tpu.AuctionSolver(loc=loc, val=val, shape=(40, 40),
                                  mode="overlapped")
    got = P.AuctionSolver(loc=loc, val=val, shape=(40, 40),
                          mode="overlapped", device="cpu")
    for _ in range(2):          # cold, then warm from the last prices
        r = ref.solve(warm_prices=ref.prices)
        g = got.solve(warm_prices=got.prices)
        np.testing.assert_array_equal(g["sol"], r["sol"])
        np.testing.assert_array_equal(_bits(g["prices"]),
                                      _bits(r["prices"]))
        assert (g["meta"]["its"], g["meta"]["phases"]) == \
            (r["meta"]["its"], r["meta"]["phases"])
        assert g["meta"]["n_shards"] == 1
        assert g["meta"]["mode"] == "overlapped" and g["meta"]["overlap"]
    with pytest.warns(UserWarning, match="warm_mode='fr'"):
        got.solve(warm_prices=got.prices, warm_mode="fr")
    with pytest.raises(ValueError, match="float64"):
        P.AuctionSolver(loc=loc, val=val, shape=(40, 40), mode="overlapped",
                        dtype=np.float64, device="cpu").solve()
    with pytest.raises(ValueError, match="square"):
        PP.auction_solve_overlapped(loc=loc, val=val, shape=(40, 41),
                                    mesh=PP.make_mesh([CPU]))
    with pytest.raises(P.InfeasibleError):
        PP.auction_solve_overlapped(loc=np.array([[0, 0], [1, 0]]),
                                    val=np.array([1, 2]), shape=(2, 2),
                                    mesh=PP.make_mesh([CPU]))


def _as_keys(best, winner):
    """The combined key table of a combined (best, winner): a bid where
    the winner is a row, else 0."""
    keys = PK._flipped_keys(best, winner.clamp(min=0)) ^ PK.KEY_FLIP
    return torch.where(winner != PA.I32_MAX, keys, torch.zeros_like(keys))


@pytest.mark.parametrize("solve", ["overlapped", "sharded_rect"])
def test_commit_keys_plain_equals_every_commit_of_a_solve(solve,
                                                          monkeypatch):
    """Every commit of a four-shard solve on the CPU (the sharded
    rectangular solve's unguarded ones with dummies, the overlapped solve's
    guarded ones), replayed through the fused commit's plain version from
    the same state as a key table: prices bits, owner and sigma equal, the
    table zeroed, and the one-pass promise (no row both evicted and
    assigned) holds."""
    commit_bids = PA.commit_bids
    seen = {"guarded": 0, "plain": 0}
    busy = []

    def spy(best, winner, prices, owner, sigma, row_offset=0, eps=None):
        out = commit_bids(best, winner, prices, owner, sigma, row_offset,
                          eps=eps)
        if busy:                 # the replay's own call
            return out
        busy.append(1)
        try:
            keys = _as_keys(best, winner)
            state = [x.clone() for x in (prices, owner, sigma)]
            PK.commit_keys_plain(keys, *state, row_offset=row_offset,
                                 eps=eps)
        finally:
            busy.pop()
        for a, b in zip(state, out):
            assert a.dtype == b.dtype and torch.equal(
                a.view(torch.int32) if a.dtype == torch.float32 else a,
                b.view(torch.int32) if b.dtype == torch.float32 else b)
        assert int(keys.count_nonzero()) == 0
        seen["plain" if eps is None else "guarded"] += 1
        return out

    monkeypatch.setattr(PA, "commit_bids", spy)
    mesh = PP.make_mesh([CPU] * 4)
    if solve == "overlapped":
        loc, val = _instance(60, False, seed=5)
        res = PP.auction_solve_overlapped(loc=loc, val=val, shape=(60, 60),
                                          mesh=mesh)
        assert seen["guarded"] == 4 * res["meta"]["its"] > 0
    else:
        rng = np.random.default_rng(6)
        loc, val, _ = random_sparse_instance(rng, 30, 38, 0.2)
        res = PP.auction_solve_sharded(loc=loc, val=val, shape=(30, 38),
                                       mesh=mesh)
        assert seen["plain"] == 4 * res["meta"]["its"] > 0
    assert res["meta"]["soln_found"]


def test_commit_keys_plain_refuses_a_broken_promise():
    """Row 3 wins column 0 and is evicted from column 1 in one commit:
    a single pass could not order that, so the plain version raises; on
    the CPU the wrapper runs the plain version and launches nothing."""
    prices = torch.zeros(2, dtype=torch.float32)
    owner = torch.tensor([-1, 3], dtype=torch.int32)
    sigma = torch.tensor([-1, -1, -1, 1], dtype=torch.int32)
    best = torch.tensor([2.0, 5.0])
    winner = torch.tensor([3, 0], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="both evicted and assigned"):
        PK.commit_keys_plain(_as_keys(best, winner), prices, owner, sigma)
    launches = PK.commit_keys.launches
    keys = _as_keys(best, torch.tensor([2, 0], dtype=torch.int32))
    PK.commit_keys(keys, prices, owner, sigma, eps=np.float32(1))
    assert PK.commit_keys.launches == launches
    assert owner.tolist() == [2, 0] and sigma.tolist() == [1, -1, 0, -1]
    assert prices.tolist() == [2.0, 5.0] and not keys.any()
    with pytest.raises(RuntimeError, match="unsupported device"):
        PK.commit_keys(keys.to("meta"), prices, owner, sigma)


class _PmaxPipeline:
    """The overlapped round in the reference's op order on (best, winner):
    K1's plain version, ``resolve_bids``, the pmax/pmin combine and the
    guarded ``commit_bids``; it starts from the neg sentinel and
    INT32_MAX, so it too commits nothing in its first round."""

    def __init__(self, n, m, device):
        self.pending = torch.zeros(n, dtype=torch.bool)
        self.rows = torch.arange(n, dtype=torch.int32)
        self.best = self.winner = None

    def round(self, cols, vals_m, nvalid, prices, owner, sigma, eps, bigp,
              row_offset, combine):
        from sslap_tpu_torch.ops import bid_topk
        n, m = sigma.shape[0], prices.shape[0]
        if self.best is None:
            self.best = torch.full((m,), PA.neg_sentinel(prices.dtype),
                                   dtype=prices.dtype)
            self.winner = torch.full((m,), PA.I32_MAX, dtype=torch.int32)
        ids = torch.where((sigma < 0) & (nvalid > 0) & ~self.pending,
                          self.rows, n)
        tgt, bid = bid_topk(ids, cols, vals_m, nvalid, prices, sigma, owner,
                            eps, bigp)
        best, winner = PA.resolve_bids(tgt, bid, m, ids + row_offset)
        p, o, s = PA.commit_bids(*combine(self.best, self.winner), prices,
                                 owner, sigma, row_offset, eps=eps)
        prices.copy_(p)
        owner.copy_(o)
        sigma.copy_(s)
        self.best, self.winner = best, winner
        self.pending = tgt < m


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("shards", [1, 3])
def test_key_table_branch_on_cpu_equals_the_cpu_branch(shards, integer,
                                                        monkeypatch):
    """The overlapped round as it runs on every device (two alternating
    key tables through the plain versions of K2's resolve and the fused
    commit, their max over the shards with bit 63 flipped) equals the same
    round in the reference's op order on (best, winner), written here:
    the same solve, and two tables a shard a phase."""
    loc, val = _instance(96, integer)
    kw = dict(loc=loc, val=val, shape=(96, 96),
              mesh=PP.make_mesh([CPU] * shards))
    got = PP.auction_solve_overlapped(**kw)
    with monkeypatch.context() as mp:
        mp.setattr(PO, "Pipeline", _PmaxPipeline)
        base = PP.auction_solve_overlapped(**kw)
    np.testing.assert_array_equal(got["sol"], base["sol"])
    np.testing.assert_array_equal(_bits(got["prices"]),
                                  _bits(base["prices"]))
    assert (got["meta"]["its"], got["meta"]["phases"]) == \
        (base["meta"]["its"], base["meta"]["phases"])
    init = PO.Pipeline.__init__
    tables = []

    def counted(self, n, m, device):
        init(self, n, m, device)
        tables.extend(self.keys)

    monkeypatch.setattr(PO.Pipeline, "__init__", counted)
    again = PP.auction_solve_overlapped(**kw)
    np.testing.assert_array_equal(again["sol"], got["sol"])
    assert len(tables) == 2 * shards * got["meta"]["phases"]


def _pmax_round(cols, vals_m, nvalid, prices, owner, sigma, eps, bigp,
                keys=None, row_offset=0, combine=None):
    """The sharded round in the reference's op order on (best, winner):
    K1's plain version, ``resolve_bids``, the pmax/pmin combine and
    ``commit_bids``."""
    from sslap_tpu_torch.ops import bid_topk
    n, m = sigma.shape[0], prices.shape[0]
    rows = torch.arange(n, dtype=torch.int32)
    ids = torch.where((sigma < 0) & (nvalid > 0), rows, n)
    tgt, bid = bid_topk(ids, cols, vals_m, nvalid, prices, sigma, owner,
                        eps, bigp)
    best, winner = combine(*PA.resolve_bids(tgt, bid, m, ids + row_offset))
    p, o, s = PA.commit_bids(best, winner, prices, owner, sigma, row_offset)
    prices.copy_(p)
    owner.copy_(o)
    sigma.copy_(s)
    return prices, owner, sigma


@pytest.mark.parametrize("shape", [(40, 40), (30, 38)])
def test_sharded_key_branch_on_cpu_equals_the_cpu_branch(shape,
                                                         monkeypatch):
    """jacobi_round's one branch (K2's resolve into a key table, the max
    of the tables, the unguarded fused commit) on four CPU shards through
    the plain versions equals the round in the reference's op order on
    (best, winner), written here as the oracle, with the dummies' step on
    a rectangle; every table is zero after each round."""
    rng = np.random.default_rng(sum(shape))
    loc, val, _ = random_sparse_instance(rng, *shape, 0.2)
    kw = dict(loc=loc, val=val, shape=shape, mesh=PP.make_mesh([CPU] * 4))
    jacobi_round = PA.jacobi_round
    seen = []

    def with_keys(cols, vals_m, nvalid, prices, owner, sigma, eps, bigp,
                  keys=None, row_offset=0, combine=None):
        out = jacobi_round(cols, vals_m, nvalid, prices, owner, sigma, eps,
                           bigp, keys, row_offset=row_offset,
                           combine=combine)
        seen.append(int(keys.count_nonzero()))
        return out

    with monkeypatch.context() as mp:
        mp.setattr(PA, "jacobi_round", _pmax_round)
        base = PP.auction_solve_sharded(**kw)
    monkeypatch.setattr(PA, "jacobi_round", with_keys)
    got = PP.auction_solve_sharded(**kw)
    np.testing.assert_array_equal(got["sol"], base["sol"])
    np.testing.assert_array_equal(_bits(got["prices"]),
                                  _bits(base["prices"]))
    assert got["meta"]["its"] == base["meta"]["its"]
    assert len(seen) == 4 * got["meta"]["its"] and not any(seen)
