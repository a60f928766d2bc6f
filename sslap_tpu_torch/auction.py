"""Auction building blocks: schedules, transforms and the full-width round.

Counterpart of ``sslap_tpu/auction.py``.  Host and scalar pieces are
numpy: the eps sequence in particular is computed on the host in the
SOLVER dtype with the reference's operation order (``_next_eps``), because
every f32 bid adds eps and so every bid bit depends on it.

``compute_bids`` / ``resolve_bids`` / ``commit_bids`` are the full-width
Jacobi round as torch ops: the oracles that the compacted kernels
(``ops/bid.py``, ``ops/commit.py``) are held against, and ``resolve_bids``
is also the resolve step of the commit kernel's plain twin.

Tie-breaks (the determinism contract): a row bids for its highest value,
lowest column among equals (ELL columns are sorted, argmax takes the first
maximum); a column goes to the highest bid, lowest row id among equals.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from sslap_tpu_torch import _native

_INT_NEG = -(2 ** 30)
I32_MAX = 2 ** 31 - 1

TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64,
                np.dtype(np.int32): torch.int32}


def torch_dtype(dtype) -> torch.dtype:
    return TORCH_DTYPES[np.dtype(dtype)]


_NUMPY_DTYPES = {v: k for k, v in TORCH_DTYPES.items()}


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return _NUMPY_DTYPES[dtype]


def neg_sentinel_np(dtype) -> np.ndarray:
    """Sentinel used only inside max-reductions and masked selects: the
    value of padded ELL slots.  Never fed into bid arithmetic."""
    dtype = np.dtype(dtype)
    if np.issubdtype(dtype, np.integer):
        return np.asarray(_INT_NEG, dtype)
    return np.asarray(np.finfo(dtype).min / 4, dtype)


def neg_sentinel(dtype):
    """Python-scalar twin of neg_sentinel_np (numpy or torch dtype), for
    ``torch.full`` and kernel scalar arguments."""
    if isinstance(dtype, torch.dtype):
        dtype = numpy_dtype(dtype)
    return neg_sentinel_np(dtype).item()


def half_neg(dtype):
    """``neg / 2`` in the dtype's own arithmetic (int: floor division): the
    line between real values and padding, as the reference draws it."""
    neg = neg_sentinel_np(dtype if not isinstance(dtype, torch.dtype)
                          else numpy_dtype(dtype))
    if np.issubdtype(neg.dtype, np.integer):
        return (neg // 2).item()
    return (neg / neg.dtype.type(2)).item()


# ---------------------------------------------------------------------------
# Transform and schedule (host)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Transform:
    """Raw costs map to internal maximization values ``v = sign*a*scale``.
    Integer costs scale by (m+1) so that the final eps = 1 phase yields an
    exactly optimal assignment."""
    sign: int
    scale: int

    def apply(self, vals: np.ndarray) -> np.ndarray:
        return vals * np.asarray(self.sign * self.scale, vals.dtype)


def make_transform(problem: str, size: int, dtype, vmax_abs: float,
                   int_exact: bool = False) -> Transform:
    """``size`` is the effective square dimension (= m)."""
    if problem not in ("min", "max"):
        raise ValueError(f"problem must be 'min' or 'max', got {problem!r}")
    sign = 1 if problem == "max" else -1
    if int_exact:
        scale = size + 1
        if vmax_abs * scale >= 2 ** 50:
            raise ValueError(
                f"integer costs too large for the exact float64 path: "
                f"max|cost| * (m+1) = {vmax_abs * scale:.3g} >= 2**50")
        return Transform(sign=sign, scale=scale)
    if np.issubdtype(np.dtype(dtype), np.integer):
        scale = size + 1
        if vmax_abs * scale >= 2 ** 26:
            raise ValueError(
                f"integer costs too large for the exact int32 path: "
                f"max|cost| * (m+1) = {vmax_abs * scale:.3g} >= 2**26. "
                f"Use float costs (eps-optimal) or reduce the cost range.")
        return Transform(sign=sign, scale=scale)
    return Transform(sign=sign, scale=1)


DEVICE_THETA = 10.0   # the reference's tiered-device default at n >= 200k
HOST_THETA = 5.0      # sslap-class schedule (CPU Gauss-Seidel)


def device_theta_default(n: int) -> float:
    """Size-aware device schedule, the reference's default.  Not yet
    re-measured on a GPU."""
    return DEVICE_THETA if n >= 200_000 else HOST_THETA


def default_eps_schedule(dtype, vmax_abs: float, size: int, scale: int,
                         eps_min=None, eps_start=None, theta=5,
                         int_exact: bool = False):
    """(eps0, eps_min, theta) as Python scalars.  Integer path: geometric
    from ~C/2 down to 1 (exact).  Float path: down to 1/(size+1), floored
    by the dtype's resolution of the cost range."""
    if theta is None:
        theta = HOST_THETA
    dtype = np.dtype(dtype)
    c = float(vmax_abs) * scale
    if int_exact:
        e_min = 1.0 if eps_min is None else float(eps_min)
        e0 = float(eps_start) if eps_start is not None else max(c / 2, e_min)
        return e0, e_min, float(theta)
    if np.issubdtype(dtype, np.integer):
        e_min = 1 if eps_min is None else int(eps_min)
        e0 = int(eps_start) if eps_start is not None else max(int(c / 2),
                                                             e_min)
        return e0, e_min, int(theta)
    if eps_min is None:
        res = 1e-12 if dtype == np.float64 else 1e-6
        e_min = max(1.0 / (size + 1), c * res)
    else:
        e_min = float(eps_min)
    e0 = float(eps_start) if eps_start is not None else max(c / 2.0, e_min)
    return e0, e_min, float(theta)


def default_max_iter(n: int) -> int:
    return min(50 * n + 2000, 10_000_000)


def _integer_pow(x, y: int):
    """x**y by square-and-multiply in x's dtype: the multiply order of
    XLA's integer_pow, which the reference's ``theta_tail ** tail_phases``
    lowers to."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return x.dtype.type(1) if acc is None else acc


def _next_eps(eps, theta, eps_min, theta_tail=None, tail_phases: int = 2):
    """Geometric eps descent with the optional MIXED tail (reference
    ``auction._next_eps``): descend by ``theta`` while eps is above
    eps_min * theta_tail**tail_phases (clamping at that threshold), then by
    ``theta_tail``; theta_tail <= 1 keeps the pure schedule.

    All arguments are numpy scalars of the solver dtype (``theta_tail`` is
    converted to it), and every step is the reference's op in its order,
    so the f32 sequence is bit-identical."""
    dt = eps.dtype.type
    is_int = np.issubdtype(eps.dtype, np.integer)
    pure = np.maximum(eps // theta if is_int else eps / theta, eps_min)
    if theta_tail is None:
        return pure
    theta_tail = dt(theta_tail)
    thresh = eps_min * _integer_pow(theta_tail, int(tail_phases))
    if is_int:
        hi = np.maximum(eps // theta, thresh)
        lo = np.maximum(eps // np.maximum(theta_tail, dt(1)), eps_min)
    else:
        hi = np.maximum(eps / theta, thresh)
        lo = np.maximum(eps / np.maximum(theta_tail, dt(1e-9)), eps_min)
    mixed = hi if eps > thresh else lo
    return mixed if theta_tail > dt(1) else pure


def validate_warm_prices(warm_prices, m: int) -> np.ndarray:
    """Shape-check a warm price vector (one dual per column)."""
    wp = np.asarray(warm_prices)
    if wp.shape != (m,):
        raise ValueError(
            f"warm_prices must have shape ({m},) -- one dual per column -- "
            f"got {wp.shape}")
    return wp


def fr_tighten(indptr, indices, data, prices, iters: int = 2) -> np.ndarray:
    """Forward-reverse dual tightening for warm starts, in place over CSR
    (transformed maximization values).  Per sweep:
    pi_i = max_j (a_ij - p_j), then p_j <- min(p_j, max(0, max_i (a_ij -
    pi_i))); prices only fall.  Native C++ when built, else numpy
    segment-max sweeps with identical results."""
    if _native.fr_tighten_native is not None and \
            _native.fr_tighten_native(indptr, indices, data, prices, iters):
        return prices
    n = indptr.shape[0] - 1
    m = prices.shape[0]
    dt = prices.dtype
    neg = (np.iinfo(dt).min if np.issubdtype(dt, np.integer)
           else np.array(-np.inf, dt))
    rows_flat = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    for _ in range(int(iters)):
        w = data - prices[indices]
        pi = np.full(n, neg, dt)
        np.maximum.at(pi, rows_flat, w)
        v = data - pi[rows_flat]
        pnew = np.full(m, neg, dt)
        np.maximum.at(pnew, indices, v)
        cand = np.where(pnew == neg, np.array(0, dt),
                        np.maximum(pnew, np.array(0, dt)))
        before = prices.copy()
        np.minimum(prices, cand, out=prices)
        if np.array_equal(before, prices):
            break
    return prices


# ---------------------------------------------------------------------------
# Full-width Jacobi round as torch ops (oracles)
# ---------------------------------------------------------------------------


def compute_bids(cols, vals_t, valid, nvalid, prices, sigma, eps, bigp
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-2 and bid over all n rows.  Returns (tgt [n] int32,
    m for non-bidders; bid [n])."""
    m = prices.shape[0]
    neg = neg_sentinel(vals_t.dtype)
    w = torch.where(valid, vals_t - prices[cols.long()],
                    torch.full_like(vals_t, neg))
    slot = torch.argmax(w, dim=1, keepdim=True)          # first max
    v1 = w.gather(1, slot)[:, 0]
    v2 = w.scatter(1, slot, neg).amax(dim=1)
    v2 = torch.where(nvalid >= 2, v2, v1 - bigp)
    # + 0: the reference's one-hot sum turns a -0.0 entry into +0.0
    a_star = vals_t.gather(1, slot)[:, 0] + 0
    jstar = cols.gather(1, slot)[:, 0]
    bid = a_star - v2 + eps
    bidding = (sigma < 0) & (nvalid > 0)
    return torch.where(bidding, jstar, m).to(torch.int32), bid


def resolve_bids(tgt, bid, m: int, row_ids
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column (best, winner): highest bid, then lowest row id.  best is
    the neg sentinel and winner INT32_MAX where no bid landed; tgt == m
    means no bid.  Scatter-reduce amax then amin over an [m+1] buffer
    whose last slot absorbs the non-bids."""
    neg = neg_sentinel(bid.dtype)
    idx = tgt.long()
    best = torch.full((m + 1,), neg, dtype=bid.dtype, device=bid.device)
    best.scatter_reduce_(0, idx, bid, "amax")
    best[m] = neg                      # fill value of the no-bid gather
    cand = torch.where(bid == best[idx], row_ids,
                       torch.full_like(row_ids, I32_MAX))
    winner = torch.full((m + 1,), I32_MAX, dtype=torch.int32,
                        device=bid.device)
    winner.scatter_reduce_(0, idx, cand, "amin")
    return best[:m], winner[:m]


def commit_bids(best, winner, prices, owner, sigma):
    """Apply resolved bids: raise prices, install winners, evict previous
    owners.  Returns new (prices, owner, sigma)."""
    m = prices.shape[0]
    n = sigma.shape[0]
    has = best > half_neg(prices.dtype)
    new_prices = torch.where(has, best, prices)
    col_idx = torch.arange(m, dtype=torch.int32, device=prices.device)
    # slot n absorbs the writes of columns that got no bid
    sig = torch.cat([sigma, sigma.new_full((1,), -1)])
    sig[torch.where(has & (owner >= 0), owner, n).long()] = -1
    sig[torch.where(has, winner, n).long()] = col_idx
    new_owner = torch.where(has, winner, owner)
    return new_prices, new_owner, sig[:n]
