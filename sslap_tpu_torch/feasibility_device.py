"""Device greedy maximal matching: the bulk of the Hopcroft-Karp check.

Counterpart of ``sslap_tpu/feasibility_device.py``.  Propose/accept rounds
(deterministic): every free row proposes to its lowest-index valid column
that is still free; each column takes its lowest-index proposer; the
losers stay in play; a row with no free candidate column drops out for
good.  Greedy never un-matches a column, so the result is a maximal
matching, and the exact Hopcroft-Karp (``feasibility.hopcroft_karp`` with
``device_seed=True``) only augments the residual, warm-started from it.

The rounds are torch ops on an explicit device; the reference runs them as
XLA ops (no Pallas kernel stands behind this module).  Active ids are
compacted by a boolean mask each round, which keeps them ascending: the
set of live rows alone decides a round (every column takes its minimum
proposer), so the matching is bit for bit the reference's whatever its
tier ladder cut.  Loop control runs on the host: the mask's count is the
one read back a round.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sslap_tpu_torch.auction import I32_MAX
from sslap_tpu_torch.ingest import ELLProblem


def build_colpack(cols: np.ndarray, valid: np.ndarray, m: int):
    """Host column table of the matcher: [n, K] int32, invalid slots = m,
    packed R = 128 // K rows a line of R * K entries, as the reference
    ships it.  Returns (data [L, R*K] int32 numpy, R).  A line is R
    contiguous rows, so ``data.view(-1, K)`` is the row table (plus up to
    R - 1 padding rows of m)."""
    n, K = cols.shape
    base = np.where(valid, cols.astype(np.int32), np.int32(m))
    R = max(128 // K, 1)
    if R == 1:
        return np.ascontiguousarray(base), 1
    npad = ((n + R - 1) // R) * R
    if npad != n:
        base = np.pad(base, ((0, npad - n), (0, 0)), constant_values=m)
    return np.ascontiguousarray(base.reshape(npad // R, R * K)), R


def _fetch_cols(rows: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """[C, K] columns of the rows ``ids`` (in range) from the row table."""
    return rows[ids.long()]


def _match_round(rows, match_row, match_col, ids):
    """One propose/accept round over the ascending live row ids ``ids``.
    ``rows`` is the [>= n, K] column table (invalid = m), ``match_col``
    [m + 1] (the last slot, the m sentinel, reads "occupied").  Updates
    the matchings IN PLACE; returns the ids that proposed and lost."""
    m = match_col.shape[0] - 1
    colsC = _fetch_cols(rows, ids)                               # [C, K]
    cand = match_col[colsC.long()] < 0        # valid (< m) and free
    has = cand.any(dim=1)
    slot = torch.argmax(cand.to(torch.uint8), dim=1, keepdim=True)
    tgt = torch.where(has, colsC.gather(1, slot)[:, 0], m)
    winner = torch.full((m + 1,), I32_MAX, dtype=torch.int32,
                        device=ids.device)
    winner.scatter_reduce_(0, tgt.long(),
                           torch.where(has, ids, I32_MAX), "amin")
    won = has & (winner[tgt.long()] == ids)
    match_col[tgt[won].long()] = ids[won]
    match_row[ids[won].long()] = tgt[won]
    return ids[has & ~won]


def greedy_matching_packed(data: torch.Tensor, nvalid: torch.Tensor, m: int,
                           n: int, K: int, R: int):
    """Greedy maximal matching over a packed column table on ``data``'s
    device.  Returns (match_row [n] int32 column or -1, match_col [m]
    int32 row or -1); the round count is kept in
    ``greedy_matching_packed.rounds``."""
    del R                          # a line is R contiguous rows of K
    dev = data.device
    rows = data.view(-1, K)
    match_row = torch.full((n,), -1, dtype=torch.int32, device=dev)
    match_col = torch.full((m + 1,), -1, dtype=torch.int32, device=dev)
    match_col[m] = 0
    ids = torch.nonzero(nvalid > 0)[:, 0].to(torch.int32)
    rounds = 0
    while ids.numel() > 0:
        ids = _match_round(rows, match_row, match_col, ids)
        rounds += 1
    greedy_matching_packed.rounds = rounds
    return match_row, match_col[:m]


greedy_matching_packed.rounds = 0


def greedy_matching(prob: ELLProblem, device="cuda"
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy maximal matching of ``prob``'s pattern on ``device`` (a CUDA
    device unless the caller asks for the CPU): the packed table is built
    on the host, shipped once, matched, and the matchings come back as
    int64 numpy arrays."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is "
                           "available")
    data, R = build_colpack(prob.cols, prob.valid, prob.m)
    mr, mc = greedy_matching_packed(
        torch.from_numpy(data).to(dev),
        torch.from_numpy(np.ascontiguousarray(prob.nvalid)).to(dev),
        m=prob.m, n=prob.n, K=prob.K, R=R)
    return (mr.cpu().numpy().astype(np.int64),
            mc.cpu().numpy().astype(np.int64))
