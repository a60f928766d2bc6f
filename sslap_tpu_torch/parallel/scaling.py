"""Comm/compute breakdown of the sharded round.  Counterpart of
``sslap_tpu/parallel/scaling.py``.

Times R rounds of the row-sharded round twice on a mesh: with the
cross-shard combine (the all-reduce of each round) and with it removed
(``sharded.local_combine``: every shard commits its own bids alone, the
same kernels and ops otherwise), and reports the difference as the
communication cost of a round.  On a mesh across machines that gives the
scaling efficiency at fixed global size, T(1 host) / T(N hosts) from
``round_s``; on one machine it measures the collectives of the mesh it is
given.  ``overlap=True`` times the overlapped round
(``overlap.Pipeline``), whose combine carries the previous round's bids.

Timing: R rounds from a cold state, best of two after a warm-up run,
completion forced by ``torch.cuda.synchronize()`` on every device of this
process's shards; a two-point fit (R1, R2) cancels the fixed costs (the
threads' start, the state's allocation).  Each process measures its own
shards' time.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sslap_tpu_torch import auction as _auction
from sslap_tpu_torch.ingest import ELLProblem
from sslap_tpu_torch.parallel.mesh import Mesh, put_global_args, run_spmd
from sslap_tpu_torch.parallel.overlap import Pipeline
from sslap_tpu_torch.parallel.partition import partition_rows, \
    shard_nnz_counts
from sslap_tpu_torch.parallel.sharded import local_combine, \
    make_pmax_combine


def _timed_rounds(prob: ELLProblem, vals_t, mesh: Mesh, eps, bigp,
                  axis_name: str, with_comm: bool, reps: int,
                  overlap: bool = False) -> float:
    """Seconds for ``reps`` rounds of the sharded (or overlapped) round on
    ``mesh`` from zero prices, with the combine or without it."""
    n_local = prob.n // mesh.shape[axis_name]
    m = prob.m
    cols, vals, valid, nvalid = put_global_args(
        mesh, ("rows",) * 4, (prob.cols, vals_t, prob.valid, prob.nvalid))
    dt = np.asarray(vals).dtype.type
    eps_, bigp_ = dt(eps), dt(bigp)

    def shard(rank: int, group):
        dev = mesh.devices[rank]
        rows = slice(rank * n_local, (rank + 1) * n_local)
        t = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a[rows])).to(dev)
        return (t(cols), _auction.mask_vals(t(vals), t(valid)),
                t(np.asarray(nvalid).astype(np.int32)))

    data = dict(zip(mesh.local_ranks(), run_spmd(mesh, shard)))

    def rounds(rank: int, group) -> None:
        c, v, nv = data[rank]
        dev = c.device
        prices = torch.zeros(m, dtype=v.dtype, device=dev)
        owner = torch.full((m,), -1, dtype=torch.int32, device=dev)
        sigma = torch.full((n_local,), -1, dtype=torch.int32, device=dev)
        combine = (make_pmax_combine(group, rank) if with_comm
                   else local_combine)
        lo = rank * n_local
        if overlap:
            pipe = Pipeline(n_local, m, dev)
            for _ in range(reps):
                pipe.round(c, v, nv, prices, owner, sigma, eps_, bigp_, lo,
                           combine)
            return
        keys = (torch.zeros(m, dtype=torch.int64, device=dev)
                if dev.type == "cuda" else None)
        for _ in range(reps):
            _auction.jacobi_round(c, v, nv, prices, owner, sigma, eps_,
                                  bigp_, keys, row_offset=lo,
                                  combine=combine)

    cards = {mesh.devices[r] for r in mesh.local_ranks()
             if mesh.devices[r].type == "cuda"}

    def once() -> float:
        for d in cards:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        run_spmd(mesh, rounds)
        for d in cards:
            torch.cuda.synchronize(d)
        return time.perf_counter() - t0

    once()                               # warm-up
    return min(once(), once())


def measure_round_breakdown(prob: ELLProblem, mesh: Mesh, *,
                            problem: str = "min", axis_name: str = "rows",
                            r1: int = 4, r2: int = 12,
                            partition: str = "rows",
                            overlap: bool = False) -> dict:
    """Per-round comm vs compute of the sharded round on ``mesh``.

    Returns per-round seconds ``round_s`` (with the combine),
    ``compute_s`` (combine removed), ``comm_s`` (the difference), the
    comm fraction, ``n_shards`` and ``nnz_imbalance`` (the largest
    shard's nnz over the mean)."""
    vals, valid = prob.vals, prob.valid
    vmax = float(np.abs(vals[valid]).max()) if valid.any() else 0.0
    tr = _auction.make_transform(problem, prob.m, vals.dtype, vmax)
    n_shards = mesh.shape[axis_name]
    part, _ = partition_rows(prob, n_shards, by=partition)
    vals_t = tr.apply(part.vals)
    tvals = vals.astype(np.float64) * (tr.sign * tr.scale)
    bigp = (float(tvals[valid].max() - tvals[valid].min()) + 1.0
            if valid.any() else 1.0)
    eps = 1.0

    out = {}
    for name, with_comm in (("round_s", True), ("compute_s", False)):
        t_r1 = _timed_rounds(part, vals_t, mesh, eps, bigp, axis_name,
                             with_comm, r1, overlap=overlap)
        t_r2 = _timed_rounds(part, vals_t, mesh, eps, bigp, axis_name,
                             with_comm, r2, overlap=overlap)
        out[name] = max((t_r2 - t_r1) / (r2 - r1), 1e-9)
    out["comm_s"] = max(out["round_s"] - out["compute_s"], 0.0)
    out["comm_fraction"] = out["comm_s"] / out["round_s"]
    nnz_per_shard = shard_nnz_counts(part, n_shards)
    out["n_shards"] = int(n_shards)
    out["nnz_imbalance"] = float(nnz_per_shard.max() /
                                 max(nnz_per_shard.mean(), 1.0))
    return out
