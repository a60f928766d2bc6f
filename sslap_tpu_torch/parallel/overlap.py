"""Row-sharded auction with the combine overlapped one round deep.
Counterpart of ``sslap_tpu/parallel/overlap.py``.

The plain sharded round (``parallel/sharded.py``) runs bid -> resolve ->
ALL-REDUCE -> commit, so every round waits on the combine.  Here a round

  1. BIDS against the entry prices (stale by one commit), rows with a bid
     in flight (``pending``) sitting it out;
  2. COMBINES the previous round's resolved bids across the shards;
  3. COMMITS them with the acceptance guard: a column takes its combined
     bid only if it still clears the current price by eps;
  4. keeps this round's resolved bids as the next round's pending ones.

(1) does not depend on (2), so the combine can ride beside the bid.  Why
stale bids stay right (the asynchronous auction, Bertsekas & Castanon):
prices only rise, so a stale bid overestimates nothing, and an accepted
bid still raises its price by at least eps.  A pending row does not bid
again until its outcome commits, so a committed winner is still
unassigned.  Every update is driven by the combined bids and the
replicated prices, so the replicas stay bit-identical.

A shard runs K1, K2's resolve launch alone into one of two [m] key
tables that alternate (this round's is resolved while the previous
round's is combined), the combine one max of the key tables, and the
commit the fused key commit (``ops.commit.commit_keys``, guarded), which
zeroes the table again; on the CPU each is its kernel's plain version, so
every commit there also checks the one-pass promise (no row both evicted
and assigned).  The key max ties to the lowest global row as the
reference's pmax/pmin pair does; a key reads a -0.0 bid as +0.0
(``ops.commit.decode_keys``), where pmax keeps the first shard's sign, and
no solve bids -0.0.  Across processes
(``ProcessSpanGroup``) the combine is an asynchronous all-reduce, issued
before this round's K1 and waited on before the commit: the overlap the
reference leaves to XLA's scheduler.  Within one process the shard
threads take turns, so nothing overlaps there.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from sslap_tpu_torch import auction as _auction
from sslap_tpu_torch.parallel.mesh import Mesh, ThreadGroup, fetch_global, \
    make_mesh, put_global_args, run_spmd
from sslap_tpu_torch.parallel.sharded import gather_rows, make_pmax_combine


class Pipeline:
    """One shard's one-deep pipeline: the rows with a bid in flight
    (``pending``) and two [m] key tables, the previous round's resolved
    bids and this round's.  A new pipeline commits nothing in its first
    round (its tables are all zero: no bids yet)."""

    def __init__(self, n: int, m: int, device: torch.device):
        self.pending = torch.zeros(n, dtype=torch.bool, device=device)
        self.rows = torch.arange(n, dtype=torch.int32, device=device)
        self.keys = [torch.zeros(m, dtype=torch.int64, device=device)
                     for _ in range(2)]  # [previous round's, this round's]

    def round(self, cols, vals_m, nvalid, prices, owner, sigma, eps, bigp,
              row_offset: int, combine) -> None:
        """One overlapped round; ``prices``, ``owner`` and ``sigma`` are
        updated IN PLACE.  ``combine``: ``sharded.make_pmax_combine``'s
        (or ``local_combine``, no collective)."""
        from sslap_tpu_torch.ops import bid_topk
        from sslap_tpu_torch.ops.commit import commit_keys, resolve
        n = sigma.shape[0]
        m = prices.shape[0]
        combined = combine.keys_async(self.keys[0])
        ids = torch.where((sigma < 0) & (nvalid > 0) & ~self.pending,
                          self.rows, n)
        tgt, bid = bid_topk(ids, cols, vals_m, nvalid, prices, sigma, owner,
                            eps, bigp)
        gids = ids + row_offset          # pads (tgt == m) resolve nowhere
        resolve(gids, tgt, bid, self.keys[1])
        commit_keys(combined.wait(), prices, owner, sigma, row_offset, eps)
        self.keys.reverse()
        self.pending = tgt < m


def count_left(sigma, nvalid, pending):
    """0-d tensor: this shard's rows with entries that hold no column,
    those with a bid in flight included."""
    return (((sigma < 0) & (nvalid > 0)) | pending).sum()


def overlapped_phase(cols, vals_t, valid, nvalid, prices, owner, sigma, eps,
                     bigp, row_offset: int, group: ThreadGroup, rank: int,
                     max_rounds: int, gate: int = 0, drain: bool = False):
    """Run one eps phase with one-deep overlapped combines, on shard
    ``rank`` of ``group`` (rows [row_offset, row_offset + n_local)); the
    phase ends when at most ``gate`` rows over all shards are left or
    pending, or after ``max_rounds`` rounds.  Bids still pending are
    dropped, or with ``drain`` combined and committed (guarded) after the
    last round, as the sharded hybrid's full-width regime ends
    (``parallel/sharded_compact.py``).  ``prices``, ``owner`` (replicas)
    and ``sigma`` (local rows) are updated IN PLACE.  Returns (prices,
    owner, sigma, rounds)."""
    from sslap_tpu_torch.ops.commit import commit_keys
    vals_m = _auction.mask_vals(vals_t, valid)
    pipe = Pipeline(sigma.shape[0], prices.shape[0], prices.device)
    combine = make_pmax_combine(group, rank)
    rounds = 0
    while rounds < max_rounds:
        left = group.all_reduce(rank, count_left(sigma, nvalid, pipe.pending),
                                torch.add)
        if int(left) <= gate:
            break
        pipe.round(cols, vals_m, nvalid, prices, owner, sigma, eps, bigp,
                   row_offset, combine)
        rounds += 1
    if drain:
        commit_keys(combine.keys(pipe.keys[0]), prices, owner, sigma,
                    row_offset, eps)
    return prices, owner, sigma, rounds


def solve_ell_overlapped(prob_cols, prob_vals_t, prob_valid, prob_nvalid,
                         mesh: Mesh, p0, eps0, eps_min, theta, max_iter, bigp,
                         axis_name: str = "rows", theta_tail=None,
                         tail_phases: int = 2) -> _auction.SolveResult:
    """eps-scaled row-sharded solve with overlapped combines, the
    reference's: square effective problems (rows padded to the mesh: no
    implicit dummies; rectangular instances go through
    ``parallel/sharded.py``).  Host arrays [n_pad, K] (``prob_vals_t`` the
    transformed values) and ``p0`` [m]; each phase opens with the eps-CS
    violator scan, the owner replicas re-converged by a min over the
    shards.  Returns the SolveResult with sigma gathered (``ProcessRows``
    on a mesh that spans processes) and the prices of this process's first
    replica."""
    cols, vals_t, valid, nvalid, p0 = map(np.asarray, put_global_args(
        mesh, ("rows",) * 4 + (None,),
        (prob_cols, prob_vals_t, prob_valid, prob_nvalid, p0)))
    n_pad = cols.shape[0]
    n_shards = mesh.shape[axis_name]
    if n_pad % n_shards != 0:
        raise ValueError("call pad_rows_for_mesh first")
    n_local = n_pad // n_shards
    m = p0.shape[0]
    dt = vals_t.dtype.type
    eps0_ = np.maximum(dt(eps0), dt(eps_min))
    eps_min_, theta_, bigp_ = dt(eps_min), dt(theta), dt(bigp)
    theta_tail_ = None if theta_tail is None else dt(theta_tail)
    max_iter = int(max_iter)

    def run(rank: int, group: ThreadGroup):
        dev = mesh.devices[rank]
        lo = rank * n_local
        t = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a[lo:lo + n_local])).to(dev)
        c, v, ok = t(cols), t(vals_t), t(valid)
        nv = t(nvalid.astype(np.int32))
        prices = torch.from_numpy(p0.astype(vals_t.dtype)).to(dev)
        owner = torch.full((m,), -1, dtype=torch.int32, device=dev)
        sigma = torch.full((n_local,), -1, dtype=torch.int32, device=dev)
        eps, rounds, phases = eps0_, 0, 0
        while True:
            rounds += overlapped_phase(c, v, ok, nv, prices, owner, sigma,
                                       eps, bigp_, lo, group, rank,
                                       max_iter - rounds)[3]
            phases += 1
            if eps <= eps_min_ or rounds >= max_iter:
                break
            eps = _auction._next_eps(eps, theta_, eps_min_,
                                     theta_tail=theta_tail_,
                                     tail_phases=tail_phases)
            _auction.unassign_violators(
                c, v, ok, prices, owner, sigma, eps, n_dummy=0,
                combine_owner=lambda o: group.all_reduce(rank, o,
                                                         torch.minimum))
        left = group.all_reduce(rank,
                                _auction.count_unassigned_rows(sigma, nv),
                                torch.add)
        return _auction.SolveResult(sigma=sigma, prices=prices,
                                    rounds=rounds, phases=phases,
                                    final_eps=eps, unassigned=int(left))

    results = run_spmd(mesh, run)
    return results[0]._replace(
        sigma=gather_rows(mesh, [r.sigma for r in results]))


def auction_solve_overlapped(mat=None, *, loc=None, val=None, shape=None,
                             problem: str = "min",
                             mesh: Optional[Mesh] = None, eps_start=None,
                             eps_min=None, theta: Optional[float] = None,
                             theta_tail: Optional[float] = None,
                             tail_phases: int = 2,
                             max_iter: Optional[int] = None,
                             cardinality_check: bool = True, dtype=None,
                             axis_name: str = "rows",
                             instrument: bool = False, warm_prices=None):
    """The reference's ``auction_solve`` with the overlapped row-sharded
    backend: same result contract, square problems only, float32/int32
    (float64 raises), over ``mesh`` (default: every local CUDA device).
    ``instrument=True`` also measures the per-round comm/compute split of
    the overlapped round on this mesh (``parallel/scaling.py`` with
    overlap=True) and adds it to the meta."""
    from sslap_tpu_torch import api as _api
    from sslap_tpu_torch import feasibility as _feas
    from sslap_tpu_torch.parallel.partition import pad_rows_for_mesh

    t0 = time.perf_counter()
    prob = _api._ingest_any(mat=mat, loc=loc, val=val, shape=shape,
                            dtype=dtype)
    if prob.n == 0:
        raise ValueError("empty problem (no rows)")
    if prob.n != prob.m:
        raise ValueError("overlapped backend requires a square problem; "
                         "use parallel.auction_solve_sharded for n < m")
    if prob.vals.dtype == np.float64:
        raise ValueError("float64 costs ride the host CPU path "
                         "(mode='cpu'); the overlapped backend is "
                         "f32/int32")
    if cardinality_check and not _feas.is_feasible(prob):
        raise _api.InfeasibleError(
            "no perfect matching exists for this sparsity pattern")
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)

    vals, valid = prob.vals, prob.valid
    vmax_abs = float(np.abs(vals[valid]).max()) if valid.any() else 0.0
    tr = _auction.make_transform(problem, prob.m, vals.dtype, vmax_abs)
    theta_eff = (_auction.device_theta_default(prob.n)
                 if theta is None else theta)
    if theta_tail is None:
        theta_tail = 3.0 if float(theta_eff) > 5 else 0.0
    if tail_phases < 1:
        raise ValueError("tail_phases must be >= 1")
    e0, e_min, theta_v = _auction.default_eps_schedule(
        vals.dtype, vmax_abs, prob.m, tr.scale, eps_min=eps_min,
        eps_start=eps_start, theta=theta_eff)
    if max_iter is None:
        max_iter = _auction.default_max_iter(prob.n)
    tvals = (vals.astype(np.int64) if np.issubdtype(vals.dtype, np.integer)
             else vals.astype(np.float64)) * (tr.sign * tr.scale)
    bigp = (float(tvals[valid].max() - tvals[valid].min()) + 1.0
            if valid.any() else 1.0)

    n_real = prob.n
    prob_p = pad_rows_for_mesh(prob, mesh.shape[axis_name])
    p0 = (np.zeros(prob.m, vals.dtype) if warm_prices is None
          else np.asarray(_auction.validate_warm_prices(warm_prices, prob.m),
                          vals.dtype))
    res = solve_ell_overlapped(
        prob_p.cols, tr.apply(prob_p.vals), prob_p.valid, prob_p.nvalid,
        mesh, p0, e0, e_min, theta_v, max_iter, bigp, axis_name=axis_name,
        theta_tail=theta_tail, tail_phases=tail_phases)
    sol = fetch_global(res.sigma)[:n_real]
    t1 = time.perf_counter()
    unassigned = res.unassigned + int((prob.nvalid == 0).sum())
    soln_found = unassigned == 0 and _auction.eps_reached(
        res.final_eps, e_min, vals.dtype)
    meta = {
        "obj": _api._objective_host(prob, sol) if soln_found else None,
        "its": res.rounds,
        "phases": res.phases,
        "soln_found": soln_found,
        "final_eps": float(res.final_eps) / tr.scale,
        "unassigned": unassigned,
        "time": t1 - t0,
        "n_shards": mesh.shape[axis_name],
        "mode": "overlapped",
        "overlap": True,
    }
    if instrument:
        from sslap_tpu_torch.parallel.scaling import measure_round_breakdown
        meta.update(measure_round_breakdown(
            prob, mesh, problem=problem, axis_name=axis_name, overlap=True))
    return _api.AuctionSolution(sol=sol, meta=meta,
                                prices=fetch_global(res.prices))
