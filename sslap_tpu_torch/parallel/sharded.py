"""Row-sharded auction solve over a mesh of devices.  Counterpart of
``sslap_tpu/parallel/sharded.py``.

Each shard owns a contiguous block of rows of the ELL layout and a
*replica* of the price and owner state, and runs ``auction.solve_ell``
with the reference's injection points.  Every Jacobi round:

  1. each shard bids for its rows (K1 over its local row ids) and folds
     the bids into its [m] key table under global row ids by K2's
     resolve launch alone (key = order bits of the bid << 32 | (2**32 - 1
     - row));
  2. the shards' tables are combined by one elementwise max, the
     reference's pmax of best then pmin of winner (highest bid, then
     lowest global row) in one pass;
  3. every shard applies the same commit to its replicas and updates the
     rows of sigma it owns: the fused key commit
     (``ops.commit.commit_keys``, which also zeroes the key table again).

On the CPU each step is its kernel's plain version.  The loop control
reads a count summed over the shards, so every shard leaves each phase
on the same round.  Each process drives its shards of
the mesh (``mesh.run_spmd``: a thread each, collectives through its
group; the shards of a process-spanning mesh reduce across processes
with ``torch.distributed``); shards on one card launch in turn on its one
stream.  With ``partition='rows'`` the result is bit-identical to the
unsharded ``solve_ell``.
"""

from __future__ import annotations

import time
import types
from typing import Optional

import numpy as np
import torch

from sslap_tpu_torch import auction as _auction
from sslap_tpu_torch.auction import I32_MAX
from sslap_tpu_torch.ingest import ELLProblem
from sslap_tpu_torch.ops.commit import KEY_FLIP
from sslap_tpu_torch.parallel.mesh import Mesh, ProcessRows, ThreadGroup, \
    fetch_global, make_mesh, run_spmd
from sslap_tpu_torch.parallel.partition import partition_rows


class _Combined:
    """The max of the shards' key tables in flight: ``wait()`` writes it
    into the shard's own table and returns that."""

    def __init__(self, keys, handle=None):
        self.keys, self.handle = keys, handle

    def wait(self):
        if self.handle is not None:
            torch.bitwise_xor(self.handle.wait(), KEY_FLIP, out=self.keys)
            self.handle = None
        return self.keys


def make_pmax_combine(group: ThreadGroup, rank: int):
    """Cross-shard combine of rank ``rank``.  ``combine.keys(keys)``, what
    the solves run, leaves the max of the shards' key tables in ``keys``
    (one all-reduce of [m] int64; bit 63 flipped around it, so the signed
    max is the keys' unsigned order: ``ops.commit.KEY_FLIP``): the highest
    bid, then the lowest row, where a zero best decodes as +0.0
    (``decode_keys``); ``combine.keys_async(keys)`` starts it and returns
    a handle whose ``wait()`` does the rest.  ``combine(best, winner)`` is
    the reference's pmax/pmin pair (two all-reduces of [m]; within a
    process the max is taken in rank order, which keeps the first of equal
    values, as pmax does with -0.0 and +0.0): the tests' oracle."""

    def combine(best, winner):
        best_g = group.all_reduce(rank, best, torch.maximum)
        cand = torch.where(best == best_g, winner,
                           torch.full_like(winner, I32_MAX))
        return best_g, group.all_reduce(rank, cand, torch.minimum)

    def keys_async(keys):
        if group.world == 1:
            return _Combined(keys)
        return _Combined(keys, group.all_reduce_async(
            rank, keys ^ KEY_FLIP, torch.maximum))

    combine.keys_async = keys_async
    combine.keys = lambda keys: keys_async(keys).wait()
    return combine


# The identity combine: each shard commits its own bids alone (the round
# without its collective, ``parallel/scaling.py``).
local_combine = types.SimpleNamespace(keys=lambda keys: keys,
                                      keys_async=_Combined)


def gather_rows(mesh: Mesh, parts):
    """This process's shards' row blocks (one tensor each, in rank order)
    as one result: a tensor on the mesh's first device, or, on a mesh
    that spans processes, a ``ProcessRows`` that ``fetch_global``
    gathers."""
    first = mesh.devices[mesh.local_ranks()[0]]
    local = torch.cat([p.to(first) for p in parts])
    return ProcessRows(local) if mesh.spans_processes else local


def sharded_solve_ell(prob: ELLProblem, vals_t: np.ndarray, mesh: Mesh,
                      p0, eps0, eps_min, theta, max_iter, bigp, n_real: int,
                      axis_name: str = "rows", theta_tail=None,
                      tail_phases: int = 2) -> _auction.SolveResult:
    """eps-scaled solve with the rows of ``prob`` (already padded to a
    multiple of the mesh size: ``pad_rows_for_mesh``) split over ``mesh``;
    ``vals_t`` [n, K] the transformed values, ``p0`` [m] the start prices,
    ``n_real`` the pre-padding row count (the dummy count is m - n_real),
    ``bigp`` the global one.  Returns the SolveResult with sigma gathered
    (``gather_rows``) and the prices of this process's first replica."""
    n_shards = mesh.shape[axis_name]
    n_pad = prob.n
    if n_pad % n_shards != 0:
        raise ValueError("call pad_rows_for_mesh first")
    n_local = n_pad // n_shards
    p0 = torch.as_tensor(p0)
    t = lambda a, dev: torch.tensor(  # noqa: E731
        np.ascontiguousarray(a), device=dev)

    def run(rank: int, group: ThreadGroup):
        dev = mesh.devices[rank]
        lo = rank * n_local
        rows = slice(lo, lo + n_local)
        nvalid = t(prob.nvalid[rows].astype(np.int32), dev)

        def count_unassigned(sigma):
            local = _auction.count_unassigned_rows(sigma, nvalid)
            return group.all_reduce(rank, local, torch.add)

        return _auction.solve_ell(
            t(prob.cols[rows], dev), t(vals_t[rows], dev),
            t(prob.valid[rows], dev), nvalid, p0.to(dev), eps0, eps_min,
            theta, max_iter, combine=make_pmax_combine(group, rank),
            count_unassigned=count_unassigned, row_offset=lo,
            n_global=n_real, bigp=bigp, theta_tail=theta_tail,
            tail_phases=tail_phases,
            combine_owner=lambda o: group.all_reduce(rank, o,
                                                     torch.minimum))

    results = run_spmd(mesh, run)
    return results[0]._replace(
        sigma=gather_rows(mesh, [r.sigma for r in results]))


def auction_solve_sharded(mat=None, *, loc=None, val=None, shape=None,
                          problem: str = "min", mesh: Optional[Mesh] = None,
                          eps_start=None, eps_min=None,
                          theta: Optional[float] = None,
                          theta_tail: Optional[float] = None,
                          tail_phases: int = 2,
                          max_iter: Optional[int] = None,
                          cardinality_check: bool = True, dtype=None,
                          axis_name: str = "rows", partition: str = "rows",
                          instrument: bool = False, warm_prices=None):
    """The reference's sharded ``auction_solve``: same inputs and result
    contract, the solve row-partitioned over ``mesh`` (default: every
    local CUDA device).  ``partition``: 'rows' (contiguous blocks,
    bit-identical to the unsharded solve) or 'nnz' (rows relabeled so the
    shards carry near-equal nnz; the same optimum, assignments may differ
    on cost ties).  ``instrument=True`` also measures the per-round
    comm/compute split on this mesh (``parallel/scaling.py``) and adds
    ``round_s``, ``compute_s``, ``comm_s``, ``comm_fraction``,
    ``nnz_imbalance`` to the meta."""
    from sslap_tpu_torch import api as _api
    from sslap_tpu_torch import feasibility as _feas

    t0 = time.perf_counter()
    prob = _api._ingest_any(mat=mat, loc=loc, val=val, shape=shape,
                            dtype=dtype)
    if prob.n == 0:
        raise ValueError("empty problem (no rows)")
    if prob.vals.dtype == np.float64:
        raise ValueError("float64 costs ride the host CPU path "
                         "(mode='cpu'); the sharded backend is f32/int32")
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
    # the global bid constant, computed on the host so that every shard's
    # bid arithmetic is the same
    tvals = (vals.astype(np.int64) if np.issubdtype(vals.dtype, np.integer)
             else vals.astype(np.float64)) * (tr.sign * tr.scale)
    bigp = (float(tvals[valid].max() - tvals[valid].min()) + 1.0
            if valid.any() else 1.0)

    n_real = prob.n
    prob_p, row_order = partition_rows(prob, mesh.shape[axis_name],
                                       by=partition)
    p0 = (np.zeros(prob.m, vals.dtype) if warm_prices is None
          else np.asarray(_auction.validate_warm_prices(warm_prices, prob.m),
                          vals.dtype))
    res = sharded_solve_ell(prob_p, tr.apply(prob_p.vals), mesh,
                            torch.from_numpy(p0), e0, e_min, theta_v,
                            max_iter, bigp, n_real, axis_name=axis_name,
                            theta_tail=theta_tail, tail_phases=tail_phases)
    sol_p = fetch_global(res.sigma)
    if row_order is None:
        sol = sol_p[:n_real]
    else:
        sol = np.full(n_real, -1, sol_p.dtype)
        real = row_order < n_real
        sol[row_order[real]] = sol_p[real]
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
        "mode": "sharded",
    }
    if instrument:
        from sslap_tpu_torch.parallel.scaling import measure_round_breakdown
        meta.update(measure_round_breakdown(
            prob, mesh, problem=problem, axis_name=axis_name,
            partition=partition))
    return _api.AuctionSolution(sol=sol, meta=meta,
                                prices=fetch_global(res.prices))
