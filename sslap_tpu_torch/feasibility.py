"""Hopcroft-Karp maximum bipartite matching (host), and the solver's
cardinality pre-check.  Counterpart of ``sslap_tpu/feasibility.py``; the
native C++ matcher is the shared one, and the pure-Python path below is
its no-toolchain fallback with the same scan order.  ``is_feasible``
needs only the size of a maximum matching, which every maximum matching
shares: with the native library and int32 indices it computes it by the
native Pothen-Fan+ matcher, else by ``hopcroft_karp``.
``device_seed=True`` first runs the device greedy maximal matching
(``feasibility_device``) and warm-starts the augmentation from it; off by
default, as in the reference.  Unlike the reference, a device seed that
fails raises: there is no fallback to the host seed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from sslap_tpu_torch import _native
from sslap_tpu_torch.ingest import ELLProblem
from sslap_tpu_torch.utils import profiling as _prof

_INF = np.int64(2 ** 62)
# rows and columns the native size-only matcher takes (int32 indices)
_SIZE_NATIVE_MAX = 2 ** 31


def _ell_to_csr(prob: ELLProblem) -> Tuple[np.ndarray, np.ndarray]:
    counts = prob.valid.sum(axis=1).astype(np.int64)
    indptr = np.zeros(prob.n + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, prob.cols[prob.valid]


def hopcroft_karp_csr(indptr, indices, n: int, m: int,
                      use_native: bool = True,
                      init_match: Optional[Tuple[np.ndarray,
                                                 np.ndarray]] = None):
    """Maximum matching over a bipartite CSR structure.  Returns
    (match_row [n] -> col or -1, match_col [m] -> row or -1, size).
    ``init_match`` warm-starts augmentation from a partial matching."""
    indptr = np.ascontiguousarray(indptr, np.int64)
    if use_native and _native.hopcroft_karp_native is not None:
        if max(n, m) < 2 ** 31:
            return _native.hopcroft_karp_native_i32(indptr, indices, n, m,
                                                    init_match=init_match)
        indices = np.ascontiguousarray(indices, np.int64)
        if init_match is None:
            return _native.hopcroft_karp_native(indptr, indices, n, m)
        mr = np.ascontiguousarray(init_match[0], np.int64).copy()
        mc = np.ascontiguousarray(init_match[1], np.int64).copy()
        return _native.hopcroft_karp_warm_native(indptr, indices, n, m,
                                                 mr, mc)
    indices = np.ascontiguousarray(indices, np.int64)
    if init_match is not None:
        match_row = np.asarray(init_match[0], np.int64).copy()
        match_col = np.asarray(init_match[1], np.int64).copy()
    else:
        match_row = np.full(n, -1, np.int64)
        match_col = np.full(m, -1, np.int64)
        for u in range(n):                       # greedy seed
            for k in range(indptr[u], indptr[u + 1]):
                v = indices[k]
                if match_col[v] == -1:
                    match_col[v] = u
                    match_row[u] = v
                    break
    dist = np.empty(n, np.int64)
    q = np.empty(n, np.int64)
    it = np.empty(n, np.int64)
    stack = np.empty(n + 1, np.int64)
    size = int((match_row >= 0).sum())

    def bfs() -> bool:
        head = tail = 0
        found = False
        for u in range(n):
            if match_row[u] == -1:
                dist[u] = 0
                q[tail] = u
                tail += 1
            else:
                dist[u] = _INF
        while head < tail:
            u = q[head]
            head += 1
            for k in range(indptr[u], indptr[u + 1]):
                w = match_col[indices[k]]
                if w == -1:
                    found = True
                elif dist[w] == _INF:
                    dist[w] = dist[u] + 1
                    q[tail] = w
                    tail += 1
        return found

    def dfs(root: int) -> bool:
        top = 0
        stack[0] = root
        it[root] = indptr[root]
        while top >= 0:
            u = stack[top]
            advanced = False
            while it[u] < indptr[u + 1]:
                v = indices[it[u]]
                it[u] += 1
                w = match_col[v]
                if w == -1:
                    while top >= 0:              # augment along the stack
                        uu = stack[top]
                        pv = match_row[uu]
                        match_row[uu] = v
                        match_col[v] = uu
                        v = pv
                        top -= 1
                    return True
                if dist[w] == dist[u] + 1:
                    top += 1
                    stack[top] = w
                    it[w] = indptr[w]
                    advanced = True
                    break
            if not advanced:
                dist[u] = _INF
                top -= 1
        return False

    while bfs():
        for u in range(n):
            if match_row[u] == -1 and dfs(u):
                size += 1
    return match_row, match_col, size


def sanitize_matching(prob: ELLProblem, warm
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Turn a possibly-stale row->col matching into a valid partial
    matching of ``prob``'s pattern: drop rows whose edge is gone and all
    but the lowest row claiming a column.  Returns (match_row [n],
    match_col [m]) int64."""
    n, m = prob.n, prob.m
    warm = np.asarray(warm).astype(np.int64, copy=True).ravel()
    if warm.shape[0] != n:
        raise ValueError(f"warm matching has length {warm.shape[0]}, "
                         f"expected n={n}")
    indptr, indices = _ell_to_csr(prob)
    rows_of_edges = np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr))
    hit_rows = rows_of_edges[indices == warm[rows_of_edges]]
    ok = np.zeros(n, bool)
    ok[hit_rows] = True
    ok &= (warm >= 0) & (warm < m)
    warm[~ok] = -1
    claimed = np.flatnonzero(warm >= 0)
    _, first = np.unique(warm[claimed], return_index=True)
    keep = np.zeros(claimed.shape[0], bool)
    keep[first] = True
    warm[claimed[~keep]] = -1
    match_col = np.full(m, -1, np.int64)
    rows = np.flatnonzero(warm >= 0)
    match_col[warm[rows]] = rows
    return warm, match_col


def hopcroft_karp(prob: ELLProblem, use_native: bool = True,
                  device_seed: Optional[bool] = None,
                  init_match: Optional[Tuple[np.ndarray,
                                             np.ndarray]] = None,
                  device="cuda"):
    """Maximum matching of an ELLProblem's sparsity pattern.
    ``device_seed`` (None = False, the host seed): seed the augmentation
    with the greedy maximal matching computed on ``device``; it raises if
    that pass fails.  ``init_match`` (match_row, match_col) overrides the
    seed."""
    indptr, indices = _ell_to_csr(prob)
    init = init_match
    if init is None and device_seed and prob.n > 0:
        from sslap_tpu_torch import feasibility_device as _fd
        init = _fd.greedy_matching(prob, device=device)
    return hopcroft_karp_csr(indptr, indices, prob.n, prob.m,
                             use_native=use_native, init_match=init)


def is_feasible(prob: ELLProblem, use_native: bool = True,
                device_seed: Optional[bool] = None, device="cuda") -> bool:
    """True iff a perfect (all-rows) matching exists.  The native
    Pothen-Fan+ matcher counts its passes over the free rows and the rows
    it matched after the seed on the open ``hk`` span (counters
    ``passes``, ``augmented``)."""
    if prob.n == 0:
        return True
    if (prob.nvalid == 0).any():
        return False
    if not (use_native and _native.max_matching_size_native_i32 is not None
            and max(prob.n, prob.m) < _SIZE_NATIVE_MAX):
        _, _, size = hopcroft_karp(prob, use_native=use_native,
                                   device_seed=device_seed, device=device)
        return size == prob.n
    indptr, indices = _ell_to_csr(prob)
    init = None
    if device_seed:
        from sslap_tpu_torch import feasibility_device as _fd
        init = _fd.greedy_matching(prob, device=device)
    size, passes, augmented = _native.max_matching_size_native_i32(
        indptr, indices, prob.n, prob.m, init_match=init)
    sp = _prof.current()
    if sp is not None and sp.name == "hk":
        sp.count("passes", passes)
        sp.count("augmented", augmented)
    return size == prob.n
