"""Row partitioner: split an ELL problem's rows over a mesh axis.
Counterpart of ``sslap_tpu/parallel/partition.py`` (numpy, equal outputs).

  by='rows'  pad rows to a multiple of n_shards; shard s owns the contiguous
             block [s * n_local, (s + 1) * n_local).  No relabeling; global
             row ids are shard offset + local index.
  by='nnz'   also RELABEL rows so each contiguous block carries a near-equal
             share of nnz: rows sorted by nnz descending (stable) are dealt
             to shards in serpentine order -- each group of n_shards
             consecutive rows gives one row to every shard, alternating
             direction -- so row counts are equal and nnz sums balance
             even on skewed instances.  Returns the relabeling.

Padding rows have nvalid == 0: they never bid and are left out of the
unassigned counts.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from sslap_tpu_torch.ingest import ELLProblem


def pad_rows_for_mesh(prob: ELLProblem, n_shards: int) -> ELLProblem:
    """Pad rows up to a multiple of n_shards (no-op if already aligned)."""
    n_pad = (-prob.n) % n_shards
    if n_pad == 0:
        return prob

    def pad0(a, fill):
        width = [(0, n_pad)] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, width, constant_values=fill)

    return ELLProblem(cols=pad0(prob.cols, 0), vals=pad0(prob.vals, 0),
                      valid=pad0(prob.valid, False),
                      nvalid=pad0(prob.nvalid, 0), n=prob.n + n_pad,
                      m=prob.m, int_exact=prob.int_exact)


def partition_rows(prob: ELLProblem, n_shards: int, by: str = "rows"
                   ) -> Tuple[ELLProblem, Optional[np.ndarray]]:
    """Pad (and for by='nnz' relabel) rows for an n_shards row mesh.
    Returns (problem, row_order) where ``row_order[i_new] = original row``
    (None for by='rows').  To map a solution back: ``sol_orig[row_order[i]]
    = sol_new[i]`` for real rows."""
    if by not in ("rows", "nnz"):
        raise ValueError(f"unknown partition strategy {by!r}")
    padded = pad_rows_for_mesh(prob, n_shards)
    if by == "rows":
        return padded, None
    nv = padded.nvalid
    n_pad = padded.n
    order = np.argsort(-nv, kind="stable")
    g = np.arange(n_pad) // n_shards
    pos = np.arange(n_pad) % n_shards
    shard = np.where(g % 2 == 0, pos, n_shards - 1 - pos)
    row_order = np.concatenate([order[shard == s] for s in range(n_shards)])
    return ELLProblem(cols=padded.cols[row_order],
                      vals=padded.vals[row_order],
                      valid=padded.valid[row_order], nvalid=nv[row_order],
                      n=n_pad, m=padded.m,
                      int_exact=padded.int_exact), row_order


def shard_nnz_counts(prob: ELLProblem, n_shards: int) -> np.ndarray:
    """Per-shard nnz sums of a (padded) contiguous row split."""
    if prob.n % n_shards != 0:
        raise ValueError(f"{prob.n} rows do not split over {n_shards} "
                         f"shards: pad_rows_for_mesh first")
    return prob.nvalid.reshape(n_shards, -1).sum(axis=1)
