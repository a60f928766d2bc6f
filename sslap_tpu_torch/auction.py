"""Auction building blocks: schedules, transforms and the full-width round.

Counterpart of ``sslap_tpu/auction.py``.  Host and scalar pieces are
numpy: the eps sequence in particular is computed on the host in the
SOLVER dtype with the reference's operation order (``_next_eps``), because
every f32 bid adds eps and so every bid bit depends on it.

``compute_bids`` / ``resolve_bids`` / ``commit_bids`` are the full-width
Jacobi round as torch ops: the oracles that the compacted kernels
(``ops/bid.py``, ``ops/commit.py``) are held against, and ``resolve_bids``
is also the resolve step of the commit kernel's plain twin.

``jacobi_round`` is that round as the solver runs it (K1 then K2 over the
id list of the rows that bid), and with ``dummy_grab_step``,
``unassign_violators`` and ``solve_ell`` it makes the Jacobi device path:
``mode='device'`` and the rectangular hybrid's device phases.  The
reference's injection points (``combine``, ``count_unassigned``,
``row_offset``, ``combine_owner``, ``on_round``) let one shard of rows run
``solve_ell`` with its collectives (``parallel/sharded.py``).

Tie-breaks (the determinism contract): a row bids for its highest value,
lowest column among equals (ELL columns are sorted, argmax takes the first
maximum); a column goes to the highest bid, lowest row id among equals.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

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


def eps_reached(final_eps, e_min, dtype) -> bool:
    """Whether an eps-scaled solve ran its schedule down to eps_min, which
    eps_min-CS (and so soln_found) needs: a round cap can stop it between
    phases with every row assigned.  Compared in the solver dtype, as
    e_min is a host float64."""
    return bool(final_eps <= np.asarray(e_min, dtype))


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


def _local_rows(rows, mask, row_offset, n: int):
    """int64 local indices of the global ``rows`` where ``mask`` holds and
    the row lies in this shard's [row_offset, row_offset + n), else n."""
    loc = rows.long() - row_offset
    return torch.where(mask & (loc >= 0) & (loc < n), loc, n)


def commit_bids(best, winner, prices, owner, sigma, row_offset=0, eps=None):
    """Apply resolved bids: raise prices, install winners, evict previous
    owners.  ``sigma`` may be a shard's rows (global ids ``row_offset`` +
    its index): winner and owner carry global ids, and rows outside the
    shard are left alone.  With ``eps`` the commit is guarded, as the
    overlapped round's (``parallel/overlap.py``): a column takes its bid
    only if it still clears the current price by eps.  Returns new
    (prices, owner, sigma)."""
    m = prices.shape[0]
    n = sigma.shape[0]
    if eps is None:
        has = best > half_neg(prices.dtype)
    else:
        has = (winner != I32_MAX) & (best >= prices + eps)
    new_prices = torch.where(has, best, prices)
    col_idx = torch.arange(m, dtype=torch.int32, device=prices.device)
    # slot n absorbs the writes of columns that got no bid
    sig = torch.cat([sigma, sigma.new_full((1,), -1)])
    sig[_local_rows(owner, has & (owner >= 0), row_offset, n)] = -1
    sig[_local_rows(winner, has, row_offset, n)] = col_idx
    new_owner = torch.where(has, winner, owner)
    return new_prices, new_owner, sig[:n]


def value_bigp(vals_t: torch.Tensor, valid: torch.Tensor):
    """max(vmax - vmin, 0) + 1 over the valid values, in their dtype: the
    finite stand-in for a missing second best."""
    neg = neg_sentinel(vals_t.dtype)
    vmax = torch.where(valid, vals_t, torch.full_like(vals_t, neg)).max()
    vmin = torch.where(valid, vals_t, torch.full_like(vals_t, -neg)).min()
    return (torch.clamp(vmax - vmin, min=0) + 1).item()


def mask_vals(vals_t: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Padding = neg sentinel, so padded slots never win a top-2."""
    return torch.where(valid, vals_t,
                       torch.full_like(vals_t, neg_sentinel(vals_t.dtype)))


# ---------------------------------------------------------------------------
# The Jacobi device path: full-width rounds, implicit dummies, eps scaling
# ---------------------------------------------------------------------------


class AuctionState(NamedTuple):
    """Carried state of the scaled auction; (prices, owner, sigma, eps) is
    the whole algorithm state."""
    prices: torch.Tensor    # [m]
    owner: torch.Tensor     # [m] int32 row owning column j, -1 free, -2 dummy
    sigma: torch.Tensor     # [n] int32 column of row i, -1 free
    eps: np.generic         # solver-dtype scalar
    rounds: int
    phases: int


class SolveResult(NamedTuple):
    sigma: torch.Tensor     # [n] int32
    prices: torch.Tensor    # [m]
    rounds: int
    phases: int
    final_eps: np.generic   # solver-dtype scalar
    unassigned: int         # biddable rows left unassigned


def jacobi_round(cols, vals_m, nvalid, prices, owner, sigma, eps, bigp,
                 keys=None, row_offset=0, combine=None):
    """One full-width Jacobi round: every unassigned row with entries bids
    (K1 over the id list ``sigma < 0 & nvalid > 0``, pad = n, which are
    exactly the rows ``compute_bids`` leaves unmasked), then K2 resolves
    and commits.  ``vals_m``: values with padding = neg sentinel.
    ``prices``, ``owner`` and ``sigma`` are updated IN PLACE and returned;
    ``keys`` is K2's [m] int64 scratch (all zero on entry and exit).

    With ``combine`` the rows are one shard (global ids ``row_offset`` +
    local id): K2's resolve launch alone folds the shard's bids into
    ``keys`` (allocated here when None) under global ids,
    ``combine.keys(keys)`` leaves the max of the shards' key tables in
    it, and the fused key commit (``ops.commit.commit_keys``: decode,
    commit, ``keys`` zeroed) applies the same commit to every shard's
    replicas; on the CPU each is its kernel's plain version.  This equals
    ``resolve_bids``, the reference's pmax/pmin combine and
    ``commit_bids``, the tests' oracle."""
    from sslap_tpu_torch.ops import bid_topk, commit
    from sslap_tpu_torch.ops.commit import commit_keys, resolve
    n = sigma.shape[0]
    rows = torch.arange(n, dtype=torch.int32, device=sigma.device)
    ids = torch.where((sigma < 0) & (nvalid > 0), rows, n)
    tgt, bid = bid_topk(ids, cols, vals_m, nvalid, prices, sigma, owner, eps,
                        bigp)
    if combine is None:
        commit(ids, tgt, bid, prices, owner, sigma, keys)
        return prices, owner, sigma
    if keys is None:
        keys = torch.zeros(prices.shape[0], dtype=torch.int64,
                           device=prices.device)
    resolve(ids + row_offset, tgt, bid, keys)   # pads (tgt == m): nowhere
    commit_keys(combine.keys(keys), prices, owner, sigma, row_offset)
    return prices, owner, sigma


# Rectangular (n < m) problems: the (m - n) implicit dummy rows value every
# column at 0, so the square extension's optimum restricted to the real
# rows is the rectangular optimum.  All unassigned dummies are alike: one
# step places them on the u_d cheapest columns at price t + eps, t the
# (u_d + 1)-th smallest price (ties to the lowest column).  Columns held by
# dummies carry owner == DUMMY_OWNER.

DUMMY_OWNER = -2


def count_unassigned_dummies(owner: torch.Tensor, n_dummy: int):
    """0-d tensor: dummies not holding a column."""
    return n_dummy - (owner == DUMMY_OWNER).sum()


# The dummy step and the violator scan take B instances laid end to end:
# prices/owner [B * m], sigma [B * n] holding flattened columns b * m + c,
# cols the same ids.  ``eps`` is a [B] tensor (each instance's own) or one
# scalar, and then B = 1; ``lanes`` ([B] bool tensor, None = all) limits
# the update to those instances.


def _lane_eps(eps):
    """(B, eps per lane as [B, 1] or the scalar)."""
    if torch.is_tensor(eps):
        return eps.shape[0], eps[:, None]
    return 1, eps


def dummy_grab_step(prices, owner, sigma, eps, n_dummy: int, lanes=None,
                    row_offset=0):
    """Place every unassigned dummy (the reference's ``dummy_grab_step``):
    per instance the u_d cheapest columns (stable sort: ties to the lowest
    column) go to its dummies at t + eps, evicting their real owners
    (``sigma`` may be a shard's rows, as in ``commit_bids``).
    ``prices``, ``owner`` and ``sigma`` are updated IN PLACE; returns them
    and u_d ([B])."""
    B, e = _lane_eps(eps)
    m = prices.shape[0] // B
    n = sigma.shape[0]
    P, O = prices.view(B, m), owner.view(B, m)
    u_d = n_dummy - (O == DUMMY_OWNER).sum(1)
    if lanes is not None:
        u_d = torch.where(lanes, u_d, 0)
    order = torch.sort(P, dim=1, stable=True).indices
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(m, device=P.device).expand(B, m))
    grab = rank < u_d[:, None]
    t = P.gather(1, order.gather(1, u_d.clamp(0, m - 1)[:, None]))
    sig = torch.cat([sigma, sigma.new_full((1,), -1)])
    sig[_local_rows(O, grab & (O >= 0), row_offset, n).reshape(-1)] = -1
    sigma.copy_(sig[:n])
    O.copy_(torch.where(grab, DUMMY_OWNER, O))
    P.copy_(torch.where(grab, t + e, P))
    return prices, owner, sigma, u_d


def unassign_violators(cols, vals_t, valid, prices, owner, sigma, eps,
                       n_dummy: int, lanes=None, combine_owner=None):
    """Unassign only the pairs that violate eps-CS at the new ``eps``,
    keeping the rest as the phase's warm start; with dummies, also free
    dummy-held columns priced above the instance's min(prices) + eps.
    ``vals_t`` may be masked or not (only valid slots are read).
    ``owner`` and ``sigma`` are updated IN PLACE and returned.  On a shard
    of rows each shard frees only its own rows' columns in its owner
    replica; ``combine_owner`` (a min over the shards: freed -1 is below
    every row id) makes the replicas equal again."""
    B, e = _lane_eps(eps)
    M = prices.shape[0]
    n = sigma.shape[0] // B
    neg = neg_sentinel(vals_t.dtype)
    w = torch.where(valid, vals_t - prices[cols.long()],
                    torch.full_like(vals_t, neg))
    v1 = w.amax(dim=1)
    cur_hit = (cols == sigma[:, None]) & valid
    cur = torch.where(cur_hit, w, torch.zeros_like(w)).sum(dim=1)
    e_row = e.repeat_interleave(n) if torch.is_tensor(e) else e
    viol = (sigma >= 0) & (cur < v1 - e_row)
    if lanes is not None:
        viol &= lanes.repeat_interleave(n)
    own = torch.cat([owner, owner.new_full((1,), -1)])
    own[torch.where(viol, sigma, M).long()] = -1
    sigma.masked_fill_(viol, -1)
    if n_dummy > 0:
        # a dummy values column j at -p_j: eps-CS needs p_j <= min(p) + eps
        P, O = prices.view(B, M // B), own[:M].view(B, M // B)
        viol_d = (O == DUMMY_OWNER) & (P > P.amin(1, keepdim=True) + e)
        if lanes is not None:
            viol_d &= lanes[:, None]
        O.masked_fill_(viol_d, -1)
    owner.copy_(own[:M])
    if combine_owner is not None:
        owner.copy_(combine_owner(owner))
    return owner, sigma


def count_unassigned_rows(sigma, nvalid):
    """0-d tensor: rows with entries that hold no column."""
    return ((sigma < 0) & (nvalid > 0)).sum()


def solve_ell(cols, vals_t, valid, nvalid, p0, eps0, eps_min, theta,
              max_iter, *, combine=None, count_unassigned=None,
              row_offset=0, n_global: Optional[int] = None, bigp=None,
              on_round=None, keep_assignment: bool = True,
              combine_owner=None, theta_tail=None,
              tail_phases: int = 2) -> SolveResult:
    """eps-scaled Jacobi auction over an ELL block on ``p0``'s device (the
    reference's ``solve_ell``): per phase, full-width rounds (plus the
    dummy step when m > n_global) until every row with entries and every
    dummy is placed or ``max_iter`` rounds are spent, then eps descends and
    only the eps-CS violators are unassigned (``keep_assignment``) or the
    whole assignment is reset.  ``bigp`` None derives it from the value
    range in the solver dtype.  Loop control runs on the host: one
    unassigned count is read back per round (``lane_phases`` with one
    lane).

    The reference's injection points, for one shard of a row-sharded solve
    (``parallel/sharded.py``): ``combine`` merges the shards' resolved
    bids (see ``jacobi_round``), ``count_unassigned(sigma)`` counts over
    all shards, ``row_offset`` is the shard's first global row,
    ``combine_owner`` re-converges the owner replicas after the violator
    scan; ``n_global`` gives the dummy count m - n_global.  ``on_round``
    (round, unassigned, eps) is called after every round."""
    n = cols.shape[0]
    m = p0.shape[0]
    n_dummy = m - (n if n_global is None else n_global)
    dtype = vals_t.dtype
    dt = numpy_dtype(dtype).type
    device = p0.device
    bigp = dt(value_bigp(vals_t, valid) if bigp is None else bigp)
    vals_m = mask_vals(vals_t, valid)
    keys = torch.zeros(m, dtype=torch.int64, device=device)
    prices = p0.to(dtype, copy=True)
    owner = torch.full((m,), -1, dtype=torch.int32, device=device)
    sigma = torch.full((n,), -1, dtype=torch.int32, device=device)

    if count_unassigned is None:
        def count_unassigned(sig):
            return count_unassigned_rows(sig, nvalid)

    def left():
        c = count_unassigned(sigma)
        if n_dummy > 0:
            c = c + count_unassigned_dummies(owner, n_dummy)
        return np.array([int(c)])

    done = [0]

    def step(lanes, eps_of, eps):
        jacobi_round(cols, vals_m, nvalid, prices, owner, sigma, eps[0],
                     bigp, keys, row_offset=row_offset, combine=combine)
        if n_dummy > 0:
            dummy_grab_step(prices, owner, sigma, eps[0], n_dummy,
                            row_offset=row_offset)
        done[0] += 1
        if on_round is not None:
            on_round(done[0], int(count_unassigned(sigma)), eps[0])

    def scan(lanes, eps_of, eps):
        if keep_assignment:
            unassign_violators(cols, vals_t, valid, prices, owner, sigma,
                               eps[0], n_dummy, combine_owner=combine_owner)
        else:
            sigma.fill_(-1)
            owner.fill_(-1)

    rounds, phases, eps = lane_phases(
        1, device, dt, eps0, eps_min, theta, int(max_iter), left, step,
        scan, theta_tail=theta_tail, tail_phases=tail_phases)
    return SolveResult(sigma=sigma, prices=prices, rounds=int(rounds[0]),
                       phases=int(phases[0]), final_eps=eps[0],
                       unassigned=int(count_unassigned(sigma)))


def lane_phases(B: int, dev, dt, eps0, eps_min, theta, max_iter: int,
                active, step, scan, trunc: int = 0, theta_tail=None,
                tail_phases: int = 2):
    """The eps-scaled phase loop of B independent instances, with the
    per-lane semantics of the reference's (vmapped) while loops: a lane's
    phase runs rounds while its ``active()`` count ([B] numpy) exceeds
    ``trunc`` and it has spent fewer than ``max_iter`` rounds; then it
    stops (at eps_min or at the round cap), or its eps descends
    (``_next_eps``) and its next phase opens with the violator scan, and
    may make no round.  ``step(lanes, eps_of, eps)`` runs one round of the
    lanes in a phase and ``scan(lanes, eps_of, eps)`` the scan of the
    lanes that advance: ``lanes`` is a [B] bool tensor on ``dev``,
    ``eps_of`` every lane's eps there and ``eps`` its host copy, in the
    solver dtype ``dt``.  Returns (rounds, phases, eps) per lane."""
    eps_min, theta = dt(eps_min), dt(theta)
    eps = np.full(B, np.maximum(dt(eps0), eps_min))
    eps_of = torch.tensor(eps, device=dev)
    rounds = np.zeros(B, np.int64)
    phases = np.zeros(B, np.int64)
    in_phase = np.ones(B, bool)
    running = np.zeros(B, bool)
    while True:
        now = in_phase & (active() > trunc) & (rounds < max_iter)
        ending = in_phase & ~now
        if ending.any():
            phases[ending] += 1
            adv = ending & (eps > eps_min) & (rounds < max_iter)
            in_phase &= ~ending | adv
            if adv.any():
                for b in np.flatnonzero(adv):
                    eps[b] = _next_eps(eps[b], theta, eps_min,
                                       theta_tail=theta_tail,
                                       tail_phases=tail_phases)
                eps_of = torch.tensor(eps, device=dev)
                scan(torch.from_numpy(adv).to(dev), eps_of, eps)
            continue
        if not now.any():
            return rounds, phases, eps
        if not np.array_equal(now, running):     # one H2D per change
            running = now
            lanes = torch.from_numpy(running).to(dev)
        step(lanes, eps_of, eps)
        rounds[running] += 1
