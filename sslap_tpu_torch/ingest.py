"""Ingest: dense / COO / CSR cost matrices -> padded ELL layout (host).

Counterpart of ``sslap_tpu/ingest.py``, with the same arrays bit for bit:
``cols[n, K]`` / ``vals[n, K]`` with a validity mask, K = max nnz per row,
columns sorted ascending within each row (so the first-max argmax is the
lowest column, the documented tie-break).  The arrays stay numpy on the
host; the solver moves what it needs to its device once per solve.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from sslap_tpu_torch import _native


@dataclasses.dataclass(frozen=True)
class ELLProblem:
    """A LAP instance in padded-ELL layout (numpy arrays).

    cols:   int32 [n, K] column of each stored entry; padding = 0.
    vals:   [n, K] raw (untransformed) costs; padding = 0.
    valid:  bool [n, K] True for real entries.
    nvalid: int32 [n] number of valid entries per row.
    n, m:   problem shape (rows <= cols).
    int_exact: integer costs stored in float64 (too large for the int32
            path); exact while |cost| * (m+1) < 2**50.
    """

    cols: np.ndarray
    vals: np.ndarray
    valid: np.ndarray
    nvalid: np.ndarray
    n: int
    m: int
    int_exact: bool = False

    @property
    def K(self) -> int:
        return int(self.cols.shape[-1])

    @property
    def nnz(self) -> int:
        return int(self.nvalid.sum())


def from_reference(obj) -> ELLProblem:
    """Build the port's ELLProblem from any object carrying the reference's
    fields (``cols, vals, valid, nvalid, n, m, int_exact``), e.g. a
    ``sslap_tpu.ingest.ELLProblem``; arrays are copied to numpy."""
    return ELLProblem(cols=np.asarray(obj.cols), vals=np.asarray(obj.vals),
                      valid=np.asarray(obj.valid),
                      nvalid=np.asarray(obj.nvalid), n=int(obj.n),
                      m=int(obj.m), int_exact=bool(obj.int_exact))


def _solver_dtype(vals: np.ndarray, dtype=None, m: int = 0):
    """Pick the solver dtype and exact-integer flag.

    Integers ride int32 (exact via (m+1) scaling) while the scaled range
    fits 2**26; larger integer costs go to float64 (exact while
    |cost| * (m+1) < 2**50, solved on the CPU path).  Floats default to
    float32.  Returns (np.dtype, int_exact)."""
    if dtype is not None:
        d = np.dtype(dtype)
        return d, bool(d == np.float64 and
                       (np.issubdtype(vals.dtype, np.integer) or
                        np.issubdtype(vals.dtype, np.bool_)))
    if np.issubdtype(vals.dtype, np.integer) or \
            np.issubdtype(vals.dtype, np.bool_):
        vmax = int(np.abs(vals).max()) if vals.size else 0
        if vmax * (m + 1) < 2 ** 26:
            return np.dtype(np.int32), False
        if vmax * (m + 1) < 2 ** 50:
            return np.dtype(np.float64), True
        raise ValueError(
            f"integer costs too large for exact arithmetic: "
            f"max|cost| * (m+1) = {vmax * (m + 1):.3g} >= 2**50")
    return np.dtype(np.float32), False


def _build_ell_from_coo(rr, cc, vv, n, m, dtype, pad_to=None,
                        int_exact=False) -> ELLProblem:
    nnz = rr.shape[0]
    if nnz == 0:
        K = max(pad_to or 1, 1)
        return ELLProblem(cols=np.zeros((n, K), np.int32),
                          vals=np.zeros((n, K), dtype),
                          valid=np.zeros((n, K), bool),
                          nvalid=np.zeros((n,), np.int32),
                          n=n, m=m, int_exact=int_exact)
    if _native.build_ell_native is not None:
        built = _native.build_ell_native(rr, cc, vv.astype(dtype, copy=False),
                                         n, m, dtype, pad_to=pad_to)
        if built is not None:
            cols, vals, valid, counts, _ = built
            return ELLProblem(cols=cols, vals=vals, valid=valid,
                              nvalid=counts.astype(np.int32), n=n, m=m,
                              int_exact=int_exact)
    # numpy path: sort by (row, col) for the lowest-column tie-break
    order = np.lexsort((cc, rr))
    rr, cc, vv = rr[order], cc[order], vv[order]
    if ((rr[1:] == rr[:-1]) & (cc[1:] == cc[:-1])).any():
        raise ValueError("duplicate (row, col) entries in sparse input")
    counts = np.bincount(rr, minlength=n).astype(np.int64)
    K = int(counts.max())
    if pad_to is not None:
        K = max(K, int(pad_to))
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(nnz, dtype=np.int64) - starts[rr]
    cols = np.zeros((n, K), np.int32)
    vals = np.zeros((n, K), dtype)
    valid = np.zeros((n, K), bool)
    cols[rr, slot] = cc.astype(np.int32)
    vals[rr, slot] = vv.astype(dtype)
    valid[rr, slot] = True
    return ELLProblem(cols=cols, vals=vals, valid=valid,
                      nvalid=counts.astype(np.int32), n=n, m=m,
                      int_exact=int_exact)


def from_dense(mat, *, dtype=None, pad_to: Optional[int] = None
               ) -> ELLProblem:
    """Dense matrix -> ELLProblem.  Negative and NaN entries are
    forbidden assignments."""
    mat = np.asarray(mat)
    if mat.ndim != 2:
        raise ValueError(
            f"dense cost matrix must be 2-D, got shape {mat.shape}")
    n, m = mat.shape
    if n > m:
        raise ValueError(
            f"rows ({n}) > cols ({m}); transpose so that rows <= cols")
    if np.issubdtype(mat.dtype, np.floating):
        valid = (mat >= 0) & np.isfinite(mat)
    else:
        valid = mat >= 0
    rr, cc = np.nonzero(valid)
    vv = mat[rr, cc]
    sdt, int_exact = _solver_dtype(vv if vv.size else mat, dtype, m=m)
    return _build_ell_from_coo(rr.astype(np.int64), cc.astype(np.int64), vv,
                               n, m, sdt, pad_to=pad_to, int_exact=int_exact)


def from_coo(loc, val, *, shape: Optional[Tuple[int, int]] = None,
             dtype=None, pad_to: Optional[int] = None,
             require_nonnegative: bool = True) -> ELLProblem:
    """COO input -> ELLProblem.  ``loc``: int [nnz, 2] (row, col);
    ``val``: [nnz] costs >= 0.  Shape is inferred unless given."""
    loc = np.asarray(loc)
    val = np.asarray(val)
    if loc.ndim != 2 or loc.shape[1] != 2:
        raise ValueError(f"loc must have shape (nnz, 2), got {loc.shape}")
    if val.ndim != 1 or val.shape[0] != loc.shape[0]:
        raise ValueError("val must be 1-D with the same length as loc")
    if not np.issubdtype(loc.dtype, np.integer):
        raise ValueError("loc must be an integer array")
    rr = loc[:, 0].astype(np.int64)
    cc = loc[:, 1].astype(np.int64)
    if loc.shape[0] and (rr.min() < 0 or cc.min() < 0):
        raise ValueError("negative indices in loc")
    if shape is None:
        n = int(rr.max()) + 1 if rr.size else 0
        m = int(cc.max()) + 1 if cc.size else 0
    else:
        n, m = map(int, shape)
        if rr.size and (rr.max() >= n or cc.max() >= m):
            raise ValueError("loc indices out of bounds for given shape")
    if n > m:
        raise ValueError(
            f"rows ({n}) > cols ({m}); transpose so that rows <= cols")
    if require_nonnegative and val.size and np.nanmin(val) < 0:
        raise ValueError(
            "all sparse costs must be >= 0 (negative marks 'forbidden' only "
            "in the dense path)")
    if np.issubdtype(val.dtype, np.floating) and not np.isfinite(val).all():
        raise ValueError("non-finite values in val")
    sdt, int_exact = _solver_dtype(val, dtype, m=m)
    return _build_ell_from_coo(rr, cc, val, n, m, sdt, pad_to=pad_to,
                               int_exact=int_exact)


def from_csr(indptr, indices, data, *,
             shape: Optional[Tuple[int, int]] = None, dtype=None,
             pad_to: Optional[int] = None) -> ELLProblem:
    """CSR input -> ELLProblem (through from_coo)."""
    indptr = np.asarray(indptr)
    n = indptr.shape[0] - 1
    rr = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    cc = np.asarray(indices).astype(np.int64)
    if shape is None:
        shape = (n, int(cc.max()) + 1 if cc.size else 0)
    return from_coo(np.stack([rr, cc], axis=1), np.asarray(data),
                    shape=shape, dtype=dtype, pad_to=pad_to)
