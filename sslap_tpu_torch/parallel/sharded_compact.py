"""Row-sharded tiered-compaction auction: the sharded hybrid.  Counterpart
of ``sslap_tpu/parallel/sharded_compact.py``.

The plain sharded round (``parallel/sharded.py``) bids every local row and
all-reduces an [m] key table every round, however few rows are left.
This solve keeps the single-card hybrid's tiered compaction across a mesh:

  full-width rounds   phase starts (the eps-CS violator scan, the owner
                      replicas re-converged by a min over the shards) and
                      rounds while more than the ladder's top capacity of
                      rows is active: K1 over the local rows, K2's resolve
                      launch alone into the [m] key table, one max of the
                      shards' tables, the fused key commit
                      (``auction.jacobi_round``); with ``overlap=True``
                      the one-deep pipelined rounds of ``overlap.py``,
                      whose in-flight combine is drained at the gate.
  compact exchanges   below it, each shard keeps its active rows in a
                      sorted id buffer of capacity C (global tiers,
                      ``sharded_ladder_tiers``), bids them (K1), and the
                      shards all-gather their [C, 3] int32 triples (column,
                      the bid's bits, global row): 3 * 4 * D * C bytes a
                      round instead of an [m] table.  Every shard commits
                      the same D * C gathered bids with K2 (its resolve
                      and commit launches, with the shard's row offset:
                      price and owner replicas alike everywhere, sigma
                      written for the shard's own rows), and relists its
                      losing bidders and its evicted rows, smallest global
                      ids first.
  truncated phases    every eps phase stops once <= trunc rows are
                      active; ONE native host Gauss-Seidel pass at eps_min
                      finishes the assignment, on every process (the
                      prices are replicated, so no broadcast is needed).

``ladder_balance=True`` sizes the shards' buffers at ``balanced_cap``; rows
that overflow wait outside the buffer and a local rebuild (the same
selection as the ladder's entry, ``active_ids``) readmits them.

Determinism: rows pick the lowest column among maxima, columns the highest
bid, then the lowest GLOBAL row.  With trunc=0 the solve reproduces the
single-device tiered solve's assignment exactly; the row partition and the
tier caps change only the form of the rounds (``tier_rounds``).

Not carried, on purpose: the reference's RowPack line packing and
``fetch_rows`` (a TPU layout; its padding rule is kept: rows are padded to
a multiple of D * R, R = max(128 // (2K + 1), 1), which decides the tiers,
the buffer caps and the comm meta), the wide window layouts
(``build_sharded_wide_layouts``, ``wide_w``: their output is bit-identical
to ``vals - prices[cols]``, which K1 computes; ``wide_rounds`` is accepted
and changes nothing), the O(G^2) all-pairs resolve (it picks the same
winner as the key resolve; ``pairs_max`` is accepted and changes nothing),
the SSLAP_DEBUG_SPILL trace-time print, and ``check_vma`` (the tests
assert the replicas' equality after every round, ``on_round``).
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sslap_tpu_torch import auction as _auction
from sslap_tpu_torch.ops import bid_topk, commit
from sslap_tpu_torch.ops.commit import commit_keys, resolve
from sslap_tpu_torch.parallel.mesh import Mesh, ThreadGroup, fetch_global, \
    make_mesh, put_global_args, run_spmd
from sslap_tpu_torch.parallel.overlap import overlapped_phase
from sslap_tpu_torch.parallel.sharded import gather_rows, make_pmax_combine
from sslap_tpu_torch.utils import profiling as _prof


def sharded_ladder_tiers(n_glob: int, m: int, n_shards: int
                         ) -> Tuple[int, ...]:
    """Descending GLOBAL active-set capacities for the compact-exchange
    ladder (the reference's).  A tier-C round all-gathers 3*4*D*C bytes,
    the full-width exchange moves an [m] table, so the ladder starts at
    the largest power of two under min(2m/(3D), n/2) and steps x2 down to
    64, with 1.5x tiers interleaved above 32768."""
    cmax = max(min((2 * m) // (3 * n_shards), n_glob // 2), 64)
    c = 1 << (int(cmax).bit_length() - 1)
    tiers = []
    while c >= 64:
        half_up = 3 * (c // 2)                  # 1.5 * c
        if c >= 32768 and half_up <= cmax and half_up < n_glob:
            tiers.append(half_up)
        if c < n_glob:
            tiers.append(c)
        c //= 2
    return tuple(tiers)


def balanced_cap(C: int, n_local: int, D: int, floor: int) -> int:
    """Shard-local ladder buffer capacity under ``ladder_balance=True``:
    min(C, n_local, max(ceil(2C/D), floor)), the one definition the buffer
    sizes and the comm-bytes meta share."""
    return min(C, n_local, max(-(-2 * C // D), floor))


def comm_bytes_model(tier_rounds, tiers: Tuple[int, ...], m: int,
                     n_shards: int, elem_bytes: int = 4,
                     n_local: Optional[int] = None,
                     overlap: bool = False, cap=None) -> dict:
    """The reference's analytic collective bytes by tier, from the round
    histogram: phase starts move 3 [m] vectors (owner pmin, best pmax,
    winner pmin) except the first phase's opening round (2), full-width
    rounds 2, tier-C rounds all-gather 3 * D * cap(C) elements (a shard's
    buffer caps at its row count, or at ``balanced_cap``); ``overlap``
    adds each phase's drain combine (2 [m], outside the round counters).
    These are the reference's exchanges; the port's key table is one [m]
    int64 vector, the same bytes as the (best, winner) pair."""
    tr = [int(x) for x in np.asarray(tier_rounds)]
    if cap is None:
        cap = (lambda c: min(c, n_local)) if n_local else (lambda c: c)
    per_round = [3 * m * elem_bytes, 2 * m * elem_bytes] + \
        [3 * n_shards * cap(c) * elem_bytes for c in tiers]
    by_tier = [r * b for r, b in zip(tr, per_round)]
    # tr[0] == number of phases (one phase-start round per phase)
    adjust = -(m * elem_bytes if tr[0] >= 1 else 0)
    if overlap:
        adjust += tr[0] * 2 * m * elem_bytes
    return {
        "tier_capacities": [None, None, *tiers],
        "comm_bytes_per_round_by_tier": per_round,
        "comm_bytes_by_tier": by_tier,
        "comm_bytes_adjustments": int(adjust),
        "comm_bytes_total": int(sum(by_tier) + adjust),
        # the same rounds on the full-width design: 2 [m] a round, plus
        # the phase starts' owner re-convergence (first phase excepted)
        "comm_bytes_fullwidth_equiv": int(
            (sum(tr) * 2 + max(tr[0] - 1, 0)) * m * elem_bytes),
    }


def _bits(x: torch.Tensor) -> torch.Tensor:
    """int32 bits of a bid (the triple's middle word)."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def solve_sharded_tiered(cols, vals_m, valid, nvalid, p0, eps0, eps_min,
                         theta, max_iter, bigp, trunc, theta_tail, *,
                         mesh: Mesh, tiers: Tuple[int, ...],
                         axis_name: str = "rows", tail_phases: int = 2,
                         overlap: bool = False, balance: bool = False,
                         balance_floor: int = 256,
                         on_round: Optional[Callable] = None):
    """The device pass (the reference's ``_solve_sharded_tiered_jit``):
    host arrays [n_pad, K] (``vals_m`` transformed, padding = neg
    sentinel; rows already padded to a multiple of the mesh size) and
    ``p0`` [m], split over ``mesh``.  Returns (SolveResult with sigma
    gathered over the padded rows, tier_rounds [3 + len(tiers)]):
    tier_rounds[0] counts phase-start rounds, [1] the other full-width
    rounds, [2 + i] the ladder rounds at tiers[i], and [-1] the buffer
    rebuilds summed over the shards.  ``on_round(rank, prices, owner)``
    is called after every round (the overlapped regime: once, drained)."""
    cols, vals_m, valid, nvalid, p0 = map(np.asarray, put_global_args(
        mesh, ("rows",) * 4 + (None,), (cols, vals_m, valid, nvalid, p0)))
    n_glob = cols.shape[0]
    D = mesh.shape[axis_name]
    if n_glob % D != 0:
        raise ValueError("pad the rows to a multiple of the mesh size first")
    n_local = n_glob // D
    m = p0.shape[0]
    dt = vals_m.dtype.type
    eps_min_, theta_, bigp_ = dt(eps_min), dt(theta), dt(bigp)
    theta_tail_ = dt(theta_tail)
    eps0_ = np.maximum(dt(eps0), eps_min_)
    max_iter, trunc = int(max_iter), int(trunc)
    n_tiers = len(tiers)

    def cap_local(C: int) -> int:
        if not balance:
            return min(C, n_local)
        return balanced_cap(C, n_local, D, balance_floor)

    def run(rank: int, group: ThreadGroup):
        shard_pass = _prof.current()    # run_spmd's span of this rank
        dev = mesh.devices[rank]
        off = rank * n_local
        t = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a[off:off + n_local])).to(dev)
        with _prof.span("device_setup"):
            c, v, ok, nv = t(cols), t(vals_m), t(valid), t(
                nvalid.astype(np.int32))
            prices = torch.from_numpy(p0.astype(vals_m.dtype)).to(dev)
            owner = torch.full((m,), -1, dtype=torch.int32, device=dev)
            sigma = torch.full((n_local,), -1, dtype=torch.int32,
                               device=dev)
            keys = torch.zeros(m, dtype=torch.int64, device=dev)
            rows = torch.arange(n_local, dtype=torch.int32, device=dev)
            gids = rows + off
        combine = make_pmax_combine(group, rank)
        tier_rounds = [0] * (3 + n_tiers)
        st = dict(rounds=0, rebuilds=0, sync_s=0.0, syncs=0)

        def host(x: torch.Tensor):
            """``x`` on the host: waits for the shard's queued work."""
            t0 = time.perf_counter()
            out = x.tolist()
            st["sync_s"] += time.perf_counter() - t0
            st["syncs"] += 1
            return out

        def count_active() -> int:
            return int(host(group.all_reduce(
                rank, _auction.count_unassigned_rows(sigma, nv), torch.add)))

        def after_round() -> None:
            st["rounds"] += 1
            if on_round is not None:
                on_round(rank, prices, owner)

        def phase_start_round(eps) -> None:
            """A full-width round over every local row with the violator
            scan fused into K1; the owner replicas, each freed of its own
            rows' violators, re-converge by a min (-1 beats every row)."""
            tgt, bid = bid_topk(rows, c, v, nv, prices, sigma, owner, eps,
                                bigp_, phase_start=True)
            owner.copy_(group.all_reduce(rank, owner, torch.minimum))
            resolve(gids, tgt, bid, keys)       # pads (tgt == m): nowhere
            commit_keys(combine.keys(keys), prices, owner, sigma, off)

        def active_ids(cap: int) -> torch.Tensor:
            """The smallest global ids of the local active rows, padded
            with n_glob to ``cap``: the ladder's entry and the balanced
            rebuild select the same way."""
            live = (sigma < 0) & (nv > 0)
            return torch.sort(torch.where(live, gids, n_glob)).values[:cap]

        def exchange_round(ids, eps, Cl: int):
            """One compact exchange round at local capacity Cl.  Returns
            (the relisted ids, the global won and evicted counts, and,
            with ``balance``, this shard's wins, evictions and live
            buffer entries)."""
            lid = torch.where(ids < n_glob, ids - off, n_local)
            tgt, bid = bid_topk(lid, c, v, nv, prices, sigma, owner, eps,
                                bigp_)
            trip = torch.stack([tgt, _bits(bid), ids], 1)      # [Cl, 3]
            g = group.all_gather(rank, trip).t().contiguous()  # [3, D*Cl]
            g_bid = g[1].view(torch.float32) if bid.dtype == \
                torch.float32 else g[1]
            stay, ev, counts = commit(g[2], g[0], g_bid, prices, owner,
                                      sigma, keys, off, n_glob)
            stay_my = stay[rank * Cl:(rank + 1) * Cl]
            ev_my = torch.where((ev >= off) & (ev < off + n_local), ev,
                                n_glob)
            new_ids = torch.sort(torch.cat([stay_my, ev_my])).values[:Cl]
            if not balance:
                return (new_ids, *host(counts[:2]))
            local = torch.stack([
                (tgt < m).sum() - (stay_my < n_glob).sum(),
                (ev_my < n_glob).sum(), (new_ids < n_glob).sum()])
            return (new_ids, *host(torch.cat([counts[:2].long(), local])))

        def run_phase(eps, first: bool) -> None:
            if first:
                _auction.jacobi_round(c, v, nv, prices, owner, sigma, eps,
                                      bigp_, keys, row_offset=off,
                                      combine=combine)
            else:
                phase_start_round(eps)
            after_round()
            tier_rounds[0] += 1
            act = count_active()
            # full-width rounds down to the ladder's top capacity
            gate = max(tiers[0] if n_tiers else 0, trunc)
            rb = st["rounds"]
            if overlap:
                st["rounds"] += overlapped_phase(
                    c, v, ok, nv, prices, owner, sigma, eps, bigp_, off,
                    group, rank, max_iter - st["rounds"], gate=gate,
                    drain=True)[3]
                if on_round is not None:
                    on_round(rank, prices, owner)
                act = count_active()
            else:
                while act > gate and st["rounds"] < max_iter:
                    _auction.jacobi_round(c, v, nv, prices, owner, sigma,
                                          eps, bigp_, keys, row_offset=off,
                                          combine=combine)
                    after_round()
                    act = count_active()
            tier_rounds[1] += st["rounds"] - rb
            if not n_tiers:
                return
            ids = active_ids(cap_local(tiers[0]))
            lact = int(host(_auction.count_unassigned_rows(sigma, nv))) \
                if balance else 0
            for ti, C in enumerate(tiers):
                floor = tiers[ti + 1] if ti + 1 < n_tiers else 0
                Cl = cap_local(C)
                ids = ids[:Cl]
                rb = st["rounds"]
                while act > max(floor, trunc) and st["rounds"] < max_iter:
                    ids, nw, ne, *mine = exchange_round(ids, eps, Cl)
                    act += ne - nw
                    after_round()
                    if balance:
                        # rows that overflowed the buffer wait unassigned;
                        # a local rebuild readmits them once slots free up
                        my_win, my_ev, blive = mine
                        lact += my_ev - my_win
                        if lact > blive and blive < Cl:
                            ids = active_ids(Cl)
                            st["rebuilds"] += 1
                tier_rounds[2 + ti] += st["rounds"] - rb

        eps = eps0_
        phases = 1
        run_phase(eps, first=True)
        while not (eps <= eps_min_ or st["rounds"] >= max_iter):
            eps = _auction._next_eps(eps, theta_, eps_min_,
                                     theta_tail=theta_tail_,
                                     tail_phases=tail_phases)
            run_phase(eps, first=False)
            phases += 1
        tier_rounds[-1] = int(host(group.all_reduce(
            rank, torch.tensor(st["rebuilds"], device=dev), torch.add)))
        res = _auction.SolveResult(sigma=sigma, prices=prices,
                                   rounds=st["rounds"], phases=phases,
                                   final_eps=eps, unassigned=count_active())
        if shard_pass is not None:
            shard_pass.count("sync_wait_s", st["sync_s"])
            shard_pass.count("host_syncs", st["syncs"])
        return res, tier_rounds

    results = run_spmd(mesh, run)
    res, tier_rounds = results[0]
    return res._replace(sigma=gather_rows(
        mesh, [r.sigma for r, _ in results])), tier_rounds


class TieredSetup(NamedTuple):
    """The sharded hybrid's device pass, ready to run
    (``solve_sharded_tiered(*args, mesh=mesh, **kw)``), and what its host
    tail needs: the transform, eps_min, the transformed host CSR, the
    global bid constant and the padded row count."""
    args: tuple
    kw: dict
    tr: object
    e_min: object
    csr: tuple
    bigp: object
    n_pad: int


def prepare_sharded_tiered(prob, D: int, *, problem: str = "min",
                           eps_start=None, eps_min=None,
                           theta: Optional[float] = None,
                           theta_tail: Optional[float] = None,
                           tail_phases: int = 2,
                           max_iter: Optional[int] = None, trunc: int = 256,
                           warm_prices=None, warm_fr: int = 0,
                           tiers: Optional[Tuple[int, ...]] = None
                           ) -> TieredSetup:
    """The set-up of ``auction_solve_sharded_hybrid`` on an ingested square
    problem for a mesh of ``D`` shards: the transform and the eps schedule
    (``theta_tail`` 3.0 when theta > 5), the host CSR and ``bigp``, the
    rows padded to a multiple of D * R (the reference's padding), the
    tiers, ``trunc`` clamped to max(n // 8, 1), and the warm prices
    tightened by ``warm_fr`` forward-reverse sweeps."""
    from sslap_tpu_torch import hybrid as _hybrid
    from sslap_tpu_torch.parallel.partition import pad_rows_for_mesh

    n, m = prob.n, prob.m
    vals, valid = prob.vals, prob.valid
    vdtype = vals.dtype
    vmax_abs = float(np.abs(vals[valid]).max()) if valid.any() else 0.0
    tr = _auction.make_transform(problem, m, vdtype, vmax_abs,
                                 int_exact=prob.int_exact)
    theta_eff = (_auction.device_theta_default(n) if theta is None
                 else theta)
    if theta_tail is None:
        theta_tail = 3.0 if float(theta_eff) > 5 else 0.0
    if tail_phases < 1:
        raise ValueError("tail_phases must be >= 1")
    e0, e_min, theta_v = _auction.default_eps_schedule(
        vdtype, vmax_abs, m, tr.scale, eps_min=eps_min, eps_start=eps_start,
        theta=theta_eff, int_exact=prob.int_exact)
    if max_iter is None:
        max_iter = _auction.default_max_iter(n)

    # host CSR for the GS tail and the global bid constant
    indptr, indices, data_csr = _hybrid.ell_to_csr_transformed(
        prob, tr.sign, tr.scale)
    if valid.any():
        bigp = (data_csr.max() - data_csr.min()) + \
            (1 if np.issubdtype(vdtype, np.integer) else 1.0)
    else:
        bigp = 1

    # the reference's padding: rows to a multiple of D * R, R the rows of
    # its 128-lane line packing
    R = max(128 // (2 * prob.K + 1), 1)
    prob_p = pad_rows_for_mesh(prob, D * R)
    if tiers is None:
        tiers = sharded_ladder_tiers(prob_p.n, m, D)
    trunc_v = min(int(trunc), max(n // 8, 1))
    p0 = (np.zeros((m,), vdtype) if warm_prices is None
          else _auction.validate_warm_prices(warm_prices, m).astype(vdtype))
    if warm_prices is not None and warm_fr > 0:
        with _prof.span("fr_tighten"):
            _auction.fr_tighten(indptr, indices, data_csr, p0, iters=warm_fr)
    vals_m = np.where(prob_p.valid, tr.apply(prob_p.vals),
                      _auction.neg_sentinel_np(vdtype))
    return TieredSetup(
        args=(prob_p.cols, vals_m, prob_p.valid, prob_p.nvalid, p0, e0,
              e_min, theta_v, max_iter, bigp, trunc_v, theta_tail),
        kw=dict(tiers=tiers, tail_phases=int(tail_phases)),
        tr=tr, e_min=e_min, csr=(indptr, indices, data_csr), bigp=bigp,
        n_pad=prob_p.n)


@_prof.entry()
def auction_solve_sharded_hybrid(
    mat=None,
    *,
    loc=None,
    val=None,
    shape=None,
    problem: str = "min",
    mesh: Optional[Mesh] = None,
    eps_start=None,
    eps_min=None,
    theta: Optional[float] = None,
    theta_tail: Optional[float] = None,
    tail_phases: int = 2,
    max_iter: Optional[int] = None,
    cardinality_check: bool = True,
    dtype=None,
    axis_name: str = "rows",
    trunc: int = 256,
    warm_prices=None,
    warm_fr: int = 0,
    tiers: Optional[Tuple[int, ...]] = None,
    pairs_max: int = 8192,
    overlap: bool = False,
    ladder_balance: bool = False,
    balance_floor: int = 256,
    wide_rounds: Optional[bool] = None,
):
    """The reference's sharded hybrid solve: the row-sharded tiered device
    pass over ``mesh`` (default: every local CUDA device), phases
    truncated at ``trunc``, then ONE host Gauss-Seidel pass at eps_min.
    Same inputs and result contract (square, float32/int32; float64 and
    rectangular problems raise ``ValueError``).  ``overlap=True``
    pipelines the full-width rounds one deep; ``ladder_balance=True``
    sizes the ladder buffers at ``balanced_cap`` (meta ``ladder_rebuilds``
    counts the rebuilds over shards and phases); ``warm_fr`` sweeps of
    forward-reverse tightening are applied to ``warm_prices`` on the host.
    ``pairs_max`` and ``wide_rounds`` are accepted and change nothing (see
    the module's docstring).  The meta carries the round histogram by
    tier and the reference's analytic collective bytes
    (``comm_bytes_model``)."""
    from sslap_tpu_torch import api as _api
    from sslap_tpu_torch import feasibility as _feas
    from sslap_tpu_torch import hybrid as _hybrid
    del pairs_max, wide_rounds

    t0 = time.perf_counter()
    prob = _api._ingest_any(mat=mat, loc=loc, val=val, shape=shape,
                            dtype=dtype)
    if prob.n != prob.m:
        raise ValueError("sharded hybrid requires a square problem; use "
                         "parallel.auction_solve_sharded for n < m")
    if prob.vals.dtype == np.float64:
        raise ValueError("float64 costs ride the host CPU path "
                         "(mode='cpu'); the sharded hybrid is f32/int32")
    if cardinality_check:
        with _prof.span("hk"):
            feasible = _feas.is_feasible(prob)
        if not feasible:
            raise _api.InfeasibleError(
                "no perfect matching exists for this sparsity pattern")
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)
    D = mesh.shape[axis_name]
    n, m = prob.n, prob.m

    with _prof.span("host_tables"):
        su = prepare_sharded_tiered(
            prob, D, problem=problem, eps_start=eps_start, eps_min=eps_min,
            theta=theta, theta_tail=theta_tail, tail_phases=tail_phases,
            max_iter=max_iter, trunc=trunc, warm_prices=warm_prices,
            warm_fr=warm_fr, tiers=tiers)
    n_pad, tiers = su.n_pad, su.kw["tiers"]

    # meta["device_time"] is this span: the shards' passes and the read back
    with _prof.span("device_pass") as dp:
        res, tier_rounds = solve_sharded_tiered(
            *su.args, mesh=mesh, axis_name=axis_name, overlap=overlap,
            balance=ladder_balance, balance_floor=balance_floor, **su.kw)
        # copies: the GS tail writes prices and sigma in place
        prices = np.array(res.prices.cpu().numpy(), order="C", copy=True)
        sigma = np.array(fetch_global(res.sigma)[:n], order="C", copy=True)

    # the host GS tail, on every process (the prices are replicated)
    owner = np.full(m, -1, np.int32)
    assigned = sigma >= 0
    owner[sigma[assigned]] = np.nonzero(assigned)[0].astype(np.int32)
    e_min_v = np.asarray(su.e_min, prob.vals.dtype)
    indptr = su.csr[0]
    with _prof.span("gs_tail") as gs:
        bids = _hybrid._gs(*su.csr, prices, sigma, owner, e_min_v, su.bigp,
                           0, 100 * n + 10_000_000)

    unassigned = int(((sigma < 0) & (np.diff(indptr) > 0)).sum())
    eps_reached = _auction.eps_reached(res.final_eps, su.e_min,
                                       prob.vals.dtype)
    soln_found = unassigned == 0 and bids >= 0 and eps_reached
    obj = None
    if soln_found:
        with _prof.span("objective"):
            obj = _api._objective_host(prob, sigma)
    meta = {
        "obj": obj,
        "its": int(res.rounds),
        "host_bids": max(int(bids), 0),
        "phases": int(res.phases),
        "final_eps": (float(e_min_v) if eps_reached
                      else float(res.final_eps)) / su.tr.scale,
        "unassigned": unassigned,
        "soln_found": soln_found,
        "time": time.perf_counter() - t0,
        "device_time": dp.t1 - dp.t0,
        "host_gs_time": gs.t1 - gs.t0,
        "tier_rounds": tier_rounds[:-1],
        "ladder_rebuilds": tier_rounds[-1],
        "n_shards": int(D),
        "mode": "sharded_hybrid",
        "overlap": bool(overlap),
        "ladder_balance": bool(ladder_balance),
    }
    meta.update(comm_bytes_model(
        tier_rounds[:-1], tiers, m, D, n_local=n_pad // D, overlap=overlap,
        cap=(None if not ladder_balance else
             (lambda c: balanced_cap(c, n_pad // D, int(D),
                                     balance_floor)))))
    return _api.AuctionSolution(sol=sigma, meta=meta, prices=prices)
