"""Candidate-list tiered auction solve: the square device engine
``engine='candidates'``.  Counterpart of ``sslap_tpu/candidate.py``.

Each row carries a SHORTLIST of its kappa best entries (columns and
values) and a threshold tau, the (kappa + 1)-th best w = a - p at build
time.  Prices only rise, so tau bounds every entry outside the shortlist
for the rest of the solve, and a fast round needs kappa price reads a
row:

  v1 = max over the shortlist of (a - p); certified iff v1 >= tau
  certified   -> bid on the shortlist's best (lowest column among equals)
                 with v2' = max(v2, tau), an underbid that keeps eps-CS
  uncertified -> the row joins the rescan backlog

A rescan reads the row's whole ELL slice, rebuilds its shortlist and tau
from its top kappa + 1 and bids exactly.  A round is the fast bids over
the id list plus a rescan of ``backlog[:resc_cap]`` (skipped when the
backlog is empty), resolved and committed together by K2
(``ops.commit``: the column's highest bid wins, the lowest row among
equals, the price becomes the bid, the previous owner is evicted).  Every
phase opens with one rescan round over all rows (the first builds every
shortlist; the others also run the exact eps-CS violator scan).  Tiers of
more than ``SWITCH`` rows run candidate rounds; at and below it the
backlog folds into the id list and the rounds are compact rounds, K1 then
K2 (``ops.ladder.kernel_round``).

On a CUDA device K1 and K2 launch their kernels and the rest of a round
is torch ops, with one small read back a round (won, evicted and the
backlog's live rows, which decides whether the next round rescans); on
the CPU the same code runs K1's and K2's plain versions.  The shortlist
bid and the rescan are torch ops because the reference computes them in
XLA with no Pallas kernel behind them.

Not carried: the reference's all-pairs resolve for small joint sets
(``pairs_resolve_max`` is accepted and has no effect: its result equals
the scatter resolve's) and its 128-lane RowPack (the rescan reads
``cols``, ``vals_m`` and ``nvalid`` rows directly, as K1 does).

Bit parity with the reference: the top-k keeps ``lax.top_k``'s order
(IEEE total order, so -0.0 sorts below +0.0, then the lowest slot among
equals) by a stable descending sort of an int32 order key; the shortlist
values and a* come out of the reference's one-hot sums, which turn -0.0
into +0.0 over two or more slots (``_onehot``); the shortlist is stored as
int32 bits, which keep tau's -0.0.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from sslap_tpu_torch import auction as _auction
from sslap_tpu_torch.auction import I32_MAX, half_neg, neg_sentinel
from sslap_tpu_torch.compact import default_tiers
from sslap_tpu_torch.ops.bid import _scalar
from sslap_tpu_torch.ops.commit import commit
from sslap_tpu_torch.ops.ladder import kernel_round

DEFAULT_KAPPA = 4
SWITCH = 4096       # tiers above this run candidate rounds


class CandState(NamedTuple):
    """The solve's end state: ``tier_rounds`` [len(tiers) + 1] counts the
    phase-start rounds (index 0) and the ladder's rounds at tiers[i]
    (1 + i); ``rescans`` the rows rescanned."""
    prices: torch.Tensor    # [m]
    owner: torch.Tensor     # [m] int32, -1 free
    sigma: torch.Tensor     # [n] int32, -1 free
    sc_cols: torch.Tensor   # [n, kappa] int32 shortlist columns
    sc_vals: torch.Tensor   # [n, kappa] shortlist values (neg = empty)
    sc_tau: torch.Tensor    # [n] upper bound on every w outside it
    eps: np.generic
    rounds: int
    phases: int
    rescans: int
    tier_rounds: list


def _order_key(w: torch.Tensor) -> torch.Tensor:
    """An int32 key whose signed order is ``lax.top_k``'s order of w:
    integers as they are, floats in IEEE total order (-0.0 < +0.0)."""
    if not w.dtype.is_floating_point:
        return w
    b = w.view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def _onehot(x: torch.Tensor, width: int) -> torch.Tensor:
    """x as the reference's one-hot sum over ``width`` slots gives it: a
    sum of two or more slots turns -0.0 into +0.0; XLA reads a single
    slot as it is."""
    return x + 0 if width > 1 else x


def _topk_shortlist(wC, colsC, valsC, kappa: int, bigp):
    """Top-(kappa + 1) of wC [C, K]: (sc_cols, sc_vals, tau, v1, v2, jstar,
    a_star).  Among equal w the lowest slot comes first (ELL columns
    ascend, so the lowest column)."""
    C, K = wC.shape
    dtype = wC.dtype
    neg = neg_sentinel(dtype)
    bigp = _scalar(bigp, dtype)
    kk = min(kappa + 1, K)
    top = torch.sort(_order_key(wC), dim=1, descending=True,
                     stable=True).indices[:, :kk]
    topw = wC.gather(1, top)
    top_cols = colsC.gather(1, top)
    top_vals = _onehot(valsC.gather(1, top), K)
    real = topw > half_neg(dtype)
    sc_n = min(kappa, K)
    sc_cols = torch.where(real[:, :sc_n], top_cols[:, :sc_n], 0)
    sc_vals = torch.where(real[:, :sc_n], top_vals[:, :sc_n], neg)
    if kk > kappa:
        tau = torch.where(real[:, kappa], topw[:, kappa], neg)
    else:
        tau = torch.full((C,), neg, dtype=dtype, device=wC.device)
    if sc_n < kappa:                               # K < kappa: pad
        sc_cols = torch.cat([sc_cols, sc_cols.new_zeros(C, kappa - sc_n)], 1)
        sc_vals = torch.cat([sc_vals,
                             sc_vals.new_full((C, kappa - sc_n), neg)], 1)
    v1 = topw[:, 0]
    if kk >= 2:
        v2 = torch.where(real[:, 1], topw[:, 1], v1 - bigp)
    else:
        v2 = v1 - bigp
    return (sc_cols.to(torch.int32), sc_vals, tau, v1, v2,
            top_cols[:, 0].to(torch.int32), top_vals[:, 0])


def _fast_bids(scpack_rows, prices, sigma_rows, live, eps, bigp, kappa: int,
               dtype, m: int, phase_start: bool):
    """Shortlist bids for gathered rows: (tgt, bid, uncertified,
    viol_unassign), tgt == m for rows that do not bid."""
    neg = neg_sentinel(dtype)
    eps, bigp = _scalar(eps, dtype), _scalar(bigp, dtype)
    sc_cols = scpack_rows[:, :kappa]
    sc_vals = _bits_to(scpack_rows[:, kappa:2 * kappa], dtype)
    tau = _bits_to(scpack_rows[:, 2 * kappa], dtype)
    nv = scpack_rows[:, 2 * kappa + 1]
    real = sc_vals > half_neg(dtype)
    w = torch.where(real, sc_vals - prices[sc_cols.long()], neg)
    v1 = w.amax(dim=1)
    # the lowest COLUMN among the maxima (slots are in build-time order)
    colkey = torch.where(w == v1[:, None], sc_cols, I32_MAX)
    slot = colkey.argmin(dim=1, keepdim=True)
    v2 = w.scatter(1, slot, neg).amax(dim=1)
    v2 = torch.where(real.sum(dim=1) >= 2, v2, v1 - bigp)
    v2p = torch.maximum(v2, tau)                   # underbid-safe bound
    v2p = torch.where(nv >= 2, v2p, v1 - bigp)
    a_star = _onehot(sc_vals.gather(1, slot)[:, 0], kappa)
    jstar = sc_cols.gather(1, slot)[:, 0]
    bid = a_star - v2p + eps
    certified = v1 >= tau                          # tau == neg certifies
    if phase_start:
        # eps-CS violator scan with the v1 upper bound (it can only
        # over-unassign); ``found`` guards rows whose column left the list
        hit = (sc_cols == sigma_rows[:, None]) & real
        found = hit.any(dim=1)
        cur = torch.where(hit, w, torch.zeros_like(w)).sum(dim=1)
        assigned = sigma_rows >= 0
        viol = assigned & (~found | (cur < torch.maximum(v1, tau) - eps))
        wants = live & (nv > 0) & (~assigned | viol)
    else:
        viol = torch.zeros_like(live)
        wants = live & (nv > 0)
    bidding = wants & certified
    tgt = torch.where(bidding, jstar, m).to(torch.int32)
    return tgt, bid, wants & ~certified, viol


def _to_bits(x, dtype):
    if not dtype.is_floating_point:
        return x.to(torch.int32)
    return x.view(torch.int32)


def _bits_to(x, dtype):
    if not dtype.is_floating_point:
        return x.to(dtype)
    return x.view(dtype)


def build_scpack(sc_cols, sc_vals, sc_tau, nvalid, kappa: int):
    """The shortlist state as one [n, 2 kappa + 2] int32 table: columns,
    value bits, tau's bits, nvalid."""
    dtype = sc_vals.dtype
    return torch.cat([sc_cols.to(torch.int32), _to_bits(sc_vals, dtype),
                      _to_bits(sc_tau, dtype)[:, None],
                      nvalid.to(torch.int32)[:, None]], dim=1)


def _rescan(cols, vals_m, nvalid, scpack, prices, owner, sigma, rids, eps,
            bigp, kappa: int, phase_start: bool):
    """The K-wide rescan of ``rids`` (pad = n): rebuilds their shortlists in
    ``scpack`` and, with ``phase_start``, frees the exact eps-CS violators
    in ``owner`` and ``sigma`` (all IN PLACE).  Returns (tgt, bid)."""
    n = sigma.shape[0]
    m = prices.shape[0]
    dtype = vals_m.dtype
    eps, bigp = _scalar(eps, dtype), _scalar(bigp, dtype)
    rlive = rids < n
    idx = torch.where(rlive, rids, n - 1).long()
    colsR, valsR = cols[idx], vals_m[idx]
    wR = valsR - prices[colsR.long()]
    sc_c, sc_v, tau, v1, v2, jstar, a_star = _topk_shortlist(
        wR, colsR, valsR, kappa, bigp)
    nvR = torch.where(rlive, nvalid[idx], 0)
    v2 = torch.where(nvR >= 2, v2, v1 - bigp)
    bid = a_star - v2 + eps
    bidding = rlive & (nvR > 0)
    if phase_start:
        # the whole row is in hand: cur and v1 are exact
        sigR = torch.where(rlive, sigma[idx], -1)
        hit = (colsR == sigR[:, None]) & (wR > half_neg(dtype))
        cur = torch.where(hit, wR, torch.zeros_like(wR)).sum(dim=1)
        viol = (sigR >= 0) & (cur < v1 - eps)
        owner[sigR[viol].long()] = -1
        sigma[rids[viol].long()] = -1
        bidding = bidding & (viol | (sigR < 0))
    tgt = torch.where(bidding, jstar, m).to(torch.int32)
    upd = build_scpack(sc_c, sc_v, tau, nvR, kappa)
    scpack[rids[rlive].long()] = upd[rlive]
    return tgt, bid


def candidate_round(cols, vals_m, nvalid, scpack, prices, owner, sigma, ids,
                    backlog, eps, bigp, *, kappa: int, resc_cap: int,
                    phase_start: bool = False, pairs_resolve_max: int = 8192,
                    n_resc: Optional[int] = None, keys=None):
    """One round: shortlist bids over ``ids`` [C] (pad = n) and a rescan of
    ``backlog[:resc_cap]``, committed jointly by K2.  ``cols``, ``vals_m``
    (padding = neg sentinel) and ``nvalid`` are the rows; ``scpack``,
    ``prices``, ``owner`` and ``sigma`` are updated IN PLACE.  ``n_resc``,
    the live entries of ``backlog[:resc_cap]``, is counted here when not
    given (a read back); the rescan runs only when it is > 0.  ``keys`` is
    K2's [m] int64 scratch.  ``pairs_resolve_max`` has no effect.

    Returns (scpack, prices, owner, sigma, new_ids [C], new_backlog [B],
    n_won, n_evicted: 0-d int32 tensors, n_rescanned: int)."""
    n = sigma.shape[0]
    m = prices.shape[0]
    C = ids.shape[0]
    B = backlog.shape[0]
    dtype = prices.dtype
    resc_cap = min(resc_cap, B)
    rids = backlog[:resc_cap]
    if n_resc is None:
        n_resc = int((rids < n).sum())
    live = ids < n
    idx = torch.where(live, ids, n - 1).long()
    sigC = torch.where(live, sigma[idx], -1)
    tgt_f, bid_f, uncert, viol_f = _fast_bids(
        scpack[idx], prices, sigC, live, eps, bigp, kappa, dtype, m,
        phase_start)
    all_ids, all_tgt, all_bid = ids, tgt_f, bid_f
    if n_resc > 0:
        tgt_r, bid_r = _rescan(cols, vals_m, nvalid, scpack, prices, owner,
                               sigma, rids, eps, bigp, kappa, phase_start)
        all_ids = torch.cat([ids, torch.where(rids < n, rids, n)])
        all_tgt = torch.cat([tgt_f, tgt_r])
        all_bid = torch.cat([bid_f, bid_r])
    if phase_start:
        # fast-part violators free their column and row, then bid now
        owner[sigC[viol_f].long()] = -1
        sigma[ids[viol_f].long()] = -1
    # a skipped rescan adds only non-bidders, which change nothing here
    stay, evicted, counts = commit(all_ids, all_tgt, all_bid, prices, owner,
                                   sigma, keys)
    new_ids = torch.sort(torch.cat([stay, evicted])).values[:C]
    new_backlog = torch.sort(torch.cat([
        backlog[resc_cap:], torch.where(uncert, ids, n).to(torch.int32),
        backlog.new_full((resc_cap,), n)])).values[:B]
    return (scpack, prices, owner, sigma, new_ids, new_backlog, counts[0],
            counts[1], n_resc)


def solve_candidates(cols, vals_m, nvalid, p0, eps0, eps_min, theta,
                     max_iter, *, bigp, tiers: Optional[Tuple[int, ...]] = None,
                     trunc=0, kappa: int = DEFAULT_KAPPA):
    """eps-scaled candidate-list solve for square effective problems over
    the plain per-row layout (``vals_m`` masked: padding = neg sentinel),
    on the device of its tensors.  ``trunc`` > 0 ends every phase once <=
    trunc rows are active (the hybrid's host finisher completes the
    assignment).  Returns (SolveResult, CandState)."""
    n, K = cols.shape
    m = p0.shape[0]
    device = p0.device
    dtype = vals_m.dtype
    dt = _auction.numpy_dtype(dtype).type
    neg = neg_sentinel(dtype)
    if tiers is None:
        tiers = default_tiers(n)
    if tiers[0] != n:
        raise ValueError("top tier must cover all rows")
    bigp = dt(bigp)
    eps_min = dt(eps_min)
    eps = np.maximum(dt(eps0), eps_min)
    theta = dt(theta)
    max_iter = int(max_iter)
    trunc = int(trunc)
    keys = (torch.zeros(m, dtype=torch.int64, device=device)
            if device.type == "cuda" else None)
    all_rows = torch.arange(n, dtype=torch.int32, device=device)
    backlog0 = torch.where(nvalid > 0, all_rows, n).to(torch.int32)
    n_biddable = int((nvalid > 0).sum())
    pads = torch.full((n,), n, dtype=torch.int32, device=device)

    prices = p0.to(dtype, copy=True)
    owner = torch.full((m,), -1, dtype=torch.int32, device=device)
    sigma = torch.full((n,), -1, dtype=torch.int32, device=device)
    scpack = build_scpack(
        torch.zeros((n, kappa), dtype=torch.int32, device=device),
        torch.full((n, kappa), neg, dtype=dtype, device=device),
        torch.full((n,), neg, dtype=dtype, device=device), nvalid, kappa)
    tier_rounds = [0] * (len(tiers) + 1)
    st = dict(rounds=0, phases=0, rescans=0)

    def ladder(ids, backlog, n_back: int, act: int):
        """The tier descent at fixed eps: candidate rounds above SWITCH,
        compact rounds (K1 + K2) at and below it, where the backlog folds
        into the id list.  Buffers and counts are the reference's, live
        rows an ascending prefix of each buffer."""
        merged = False
        for ti, Ct in enumerate(tiers):
            floor_static = tiers[ti + 1] if ti + 1 < len(tiers) else 0
            resc_cap = max(min(Ct // 2, 8192), 32)
            if Ct != tiers[0]:
                ids, backlog = ids[:Ct], backlog[:Ct]
                n_back = min(n_back, Ct)
                if Ct <= SWITCH and not merged:
                    ids = torch.sort(torch.cat([ids, backlog])).values[:Ct]
                    backlog = pads[:Ct]
                    n_back = 0
                    merged = True
            elif Ct <= SWITCH:            # small problems: compact rounds
                merged = True
                ids = torch.sort(torch.cat([ids, backlog])).values[:n]
                backlog = pads
                n_back = 0
            compact = Ct <= SWITCH
            r0 = st["rounds"]
            while act > max(floor_static, trunc) and \
                    st["rounds"] < max_iter:
                if compact:
                    ids, counts = kernel_round(cols, vals_m, nvalid, prices,
                                               owner, sigma, ids, eps, bigp,
                                               keys)
                    won, evi = counts[:2].tolist()   # the round's one sync
                else:
                    (_, _, _, _, ids, backlog, won, evi,
                     n_resc) = candidate_round(
                        cols, vals_m, nvalid, scpack, prices, owner, sigma,
                        ids, backlog, eps, bigp, kappa=kappa,
                        resc_cap=resc_cap, n_resc=min(resc_cap, n_back),
                        keys=keys)
                    st["rescans"] += n_resc
                    won, evi, n_back = torch.stack([
                        won, evi, (backlog < n).sum().to(torch.int32)
                    ]).tolist()                      # the round's one sync
                act = act - won + evi
                st["rounds"] += 1
            tier_rounds[ti + 1] += st["rounds"] - r0

    def run_phase(first: bool) -> None:
        # every phase opens with one rescan round over every biddable row:
        # the first builds the shortlists, the others rebuild them at the
        # new prices with the exact violator scan
        (_, _, _, _, ids, backlog, _, _, n_resc) = candidate_round(
            cols, vals_m, nvalid, scpack, prices, owner, sigma, pads,
            backlog0, eps, bigp, kappa=kappa, resc_cap=n,
            phase_start=not first, n_resc=n_biddable, keys=keys)
        st["rescans"] += n_resc
        st["rounds"] += 1
        n_ids, n_back = torch.stack([(ids < n).sum(),
                                     (backlog < n).sum()]).tolist()
        tier_rounds[0] += 1
        ladder(ids, backlog, n_back, n_ids + n_back)
        st["phases"] += 1

    run_phase(first=True)
    done = eps <= eps_min or st["rounds"] >= max_iter
    while not done:
        eps = _auction._next_eps(eps, theta, eps_min)
        run_phase(first=False)
        done = eps <= eps_min or st["rounds"] >= max_iter
    unassigned = int(_auction.count_unassigned_rows(sigma, nvalid))
    res = _auction.SolveResult(sigma=sigma, prices=prices,
                               rounds=st["rounds"], phases=st["phases"],
                               final_eps=eps, unassigned=unassigned)
    state = CandState(
        prices=prices, owner=owner, sigma=sigma, sc_cols=scpack[:, :kappa],
        sc_vals=_bits_to(scpack[:, kappa:2 * kappa], dtype),
        sc_tau=_bits_to(scpack[:, 2 * kappa], dtype), eps=eps,
        rounds=st["rounds"], phases=st["phases"], rescans=st["rescans"],
        tier_rounds=tier_rounds)
    return res, state


def solve_ell_candidates(cols, vals_t, valid, nvalid, p0, eps0, eps_min,
                         theta, max_iter, tiers=None, bigp=None, trunc=0,
                         kappa: int = DEFAULT_KAPPA):
    """``solve_candidates`` over ELL tensors with transformed values and a
    validity mask (the reference's ``solve_ell_candidates``, same
    arguments): masks the padding and, when ``bigp`` is None, derives it
    from the value range in the solver dtype.  Returns (SolveResult,
    CandState)."""
    if bigp is None:
        bigp = _auction.value_bigp(vals_t, valid)
    return solve_candidates(cols, _auction.mask_vals(vals_t, valid), nvalid,
                            p0, eps0, eps_min, theta, max_iter, bigp=bigp,
                            tiers=tiers, trunc=trunc, kappa=kappa)
