"""Pure-numpy Gauss-Seidel auction fallback (no toolchain required).

Mirrors the native C++ engine (native/sslap_native.cpp auction_gs) bid for
bid: FIFO queue of unassigned rows, lowest-column-index argmax tie-break
(scan order), ``v2 = v1 - bigp`` for single-entry rows, implicit dummy rows
for rectangular problems, and the ``max_bids`` safety valve.  It exists so
reference-grade float64 solves (SURVEY.md SS1 dtype policy) work on hosts
without g++ (``SSLAP_TPU_NO_NATIVE=1`` or a missing compiler); it is
~30x slower than the native engine (interpreted loop, ~us/bid) and is only
selected when the native library is unavailable.
"""

from __future__ import annotations

from collections import deque

import numpy as np


def auction_gs_numpy(indptr, indices, vals, prices, sigma, owner,
                     eps, bigp, n_dummy_total: int, max_bids: int) -> int:
    """In-place Gauss-Seidel auction over CSR (transformed maximization
    values).  Modifies ``prices``/``sigma``/``owner``; returns bids
    performed, or -1 if ``max_bids`` was exhausted."""
    n = sigma.shape[0]
    m = prices.shape[0]
    queue = deque(
        int(u) for u in range(n)
        if sigma[u] < 0 and indptr[u + 1] > indptr[u])
    dummy_pending = n_dummy_total - int((owner == -2).sum())

    def evict(j: int):
        nonlocal dummy_pending
        w = owner[j]
        if w >= 0:
            sigma[w] = -1
            queue.append(int(w))
        elif w == -2:
            dummy_pending += 1

    bids = 0
    while queue or dummy_pending > 0:
        if bids >= max_bids:
            return -1
        bids += 1
        if queue:
            u = queue.popleft()
            if sigma[u] >= 0:
                continue
            lo, hi = int(indptr[u]), int(indptr[u + 1])
            w = vals[lo:hi] - prices[indices[lo:hi]]
            kbest = int(np.argmax(w))      # first max = lowest column index
            v1 = w[kbest]
            if hi - lo >= 2:
                v2 = np.delete(w, kbest).max()   # dtype-safe (ints: no inf)
            else:
                v2 = v1 - bigp
            jstar = int(indices[lo + kbest])
            bid = vals[lo + kbest] - v2 + eps
            evict(jstar)
            prices[jstar] = bid
            owner[jstar] = u
            sigma[u] = jstar
        else:
            # dummy bid: value 0 on every column -> two smallest prices
            j1 = int(np.argmin(prices))
            if m >= 2:
                p2 = np.delete(prices, j1).min()  # dtype-safe (ints: no inf)
            else:
                p2 = prices[j1] + bigp
            evict(j1)
            prices[j1] = p2 + eps
            owner[j1] = -2
            dummy_pending -= 1
    return bids


def unassign_violators_numpy(indptr, indices, vals, prices, sigma, owner,
                             eps, n_dummy_total: int) -> None:
    """In-place warm-started eps-scaling step: free only eps-CS violators
    (host mirror of auction.py:unassign_violators and the native
    sslap_unassign_violators)."""
    n = sigma.shape[0]
    counts = np.diff(indptr)
    w_flat = vals - prices[indices]
    # per-row max over CSR; empty rows yield -inf (never violators: they
    # are unassigned by invariant)
    v1 = np.full(n, -np.inf, w_flat.dtype if w_flat.dtype.kind == "f"
                 else np.float64)
    nonempty = counts > 0
    if nonempty.any():
        v1[nonempty] = np.maximum.reduceat(
            w_flat, indptr[:-1][nonempty])
    row_of = np.repeat(np.arange(n, dtype=np.int64), counts)
    assigned = sigma >= 0
    hit = assigned[row_of] & (indices == sigma[row_of])
    cur = np.full(n, np.inf, v1.dtype)
    cur[row_of[hit]] = w_flat[hit]
    viol = assigned & (cur < v1 - eps)
    if viol.any():
        owner[sigma[viol]] = -1
        sigma[viol] = -1
    # dummy-held columns: dummies value every column 0, so eps-CS for a
    # dummy at j means -p_j >= max_j'(-p_j') - eps
    if n_dummy_total > 0:
        held = owner == -2
        if held.any():
            pmin = prices.min()
            dviol = held & (prices > pmin + eps)
            owner[dviol] = -1
