"""Tiered active-row-compacted auction solve (the device half of the
square hybrid).  Counterpart of ``sslap_tpu/compact.py``.

The active (unassigned, biddable) row ids live in a compacted buffer of
static tier capacity C, and a round costs O(C):

  bid      K1 (ops.bid_topk): top-2 over K per active row, bid
  resolve  K2 (ops.commit): per column the highest bid, lowest row wins
  commit   K2: price raise, owner install, eviction (in place)
  relist   new actives = losers + evicted, sorted so the live ids form an
           ascending prefix (torch sort; the active set never grows
           within a phase, so tiers only step down)

Each eps phase opens with a full-width round that doubles as the eps-CS
violator scan (K1's ``phase_start``).  The per-row data is a plain layout,
``cols [n, K]`` int32 / ``vals_m [n, K]`` (padding = neg sentinel) /
``nvalid [n]``: the reference's 128-lane line packing (RowPack) and its
all-pairs narrow-tier resolve are TPU workarounds with no job here.

Loop control runs on the host: each round reads K2's three counts
(won, evicted, stayed) back, one small device->host copy per round, so
the round partition is exactly the reference's.  The reference ran the
whole solve as one device program; capturing the ladder in a CUDA graph
or a device-side loop is later work.

Determinism: rows pick the lowest column among maxima, columns the lowest
row among max bids; trajectories do not depend on the ladder (capacity
only pads), only the ``tier_rounds`` histogram does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from sslap_tpu_torch import auction as _auction
from sslap_tpu_torch.ops import bid_topk, commit


@dataclasses.dataclass
class TieredState:
    """Phase-boundary state: (prices, owner, sigma, eps) is the whole
    algorithm state, so a solve resumes exactly from it.  ``tier_rounds``
    [len(tiers) + 1] counts rounds by tier: index 0 the full-width rounds
    (phase starts and the wide loop), 1 + i the ladder rounds at
    tiers[i]."""
    prices: torch.Tensor    # [m]
    owner: torch.Tensor     # [m] int32, -1 free
    sigma: torch.Tensor     # [n] int32, -1 free
    eps: np.generic
    rounds: int
    phases: int
    tier_rounds: List[int]

    @classmethod
    def from_numpy(cls, st) -> "TieredState":
        """From any object with the reference TieredState's fields (e.g.
        ``sslap_tpu.compact.TieredState``), arrays copied to CPU tensors
        (``solve_tiered`` moves a resume state to its own device)."""
        def tensor(a):
            return torch.as_tensor(np.array(a))
        return cls(prices=tensor(st.prices), owner=tensor(st.owner),
                   sigma=tensor(st.sigma), eps=np.asarray(st.eps)[()],
                   rounds=int(st.rounds), phases=int(st.phases),
                   tier_rounds=[int(x) for x in np.asarray(st.tier_rounds)])


def default_tiers(n: int, *, fine: bool = False,
                  floor: int = 0) -> Tuple[int, ...]:
    """Static tier capacities, descending, top tier n (the reference's
    ladder).  Below n: powers of two down to 64, with 3*2^(k-1) tiers
    interleaved above 32768 (and everywhere with ``fine``); tiers at or
    below ``floor`` are dropped (a phase truncated at ``trunc`` never
    enters them)."""
    tiers = [n]
    c = 1 << max((n - 1).bit_length() - 1, 6)   # largest power of two < n
    while c >= 64:
        half_up = 3 * (c // 2)
        if (c >= 32768 or fine) and half_up < n and half_up > c \
                and half_up > floor:
            tiers.append(half_up)
        if c < n and c > floor:
            tiers.append(c)
        c //= 2
    return tuple(tiers)


def compact_round(cols, vals_m, nvalid, prices, owner, sigma, ids, eps, bigp,
                  *, phase_start: bool = False, keys=None):
    """One auction round over the compacted active set ``ids`` (pad = n).

    ``prices``, ``owner`` and ``sigma`` are updated IN PLACE.  With
    ``phase_start``, assigned rows in ``ids`` that violate eps-CS at
    ``eps`` are unassigned and bid in this round; otherwise every live id
    is an unassigned row by invariant.  ``keys``: K2's [m] scratch.

    Returns (new_ids [C] ascending, pad = n; counts [3] int32 on the
    device: won, evicted, stayed)."""
    tgt, bid = bid_topk(ids, cols, vals_m, nvalid, prices, sigma, owner,
                        eps, bigp, phase_start=phase_start)
    stay, evicted, counts = commit(ids, tgt, bid, prices, owner, sigma,
                                   keys)
    new_ids = torch.sort(torch.cat([stay, evicted])).values[:ids.shape[0]]
    return new_ids, counts


def _round(cols, vals_m, nvalid, prices, owner, sigma, ids, eps, bigp,
           keys, phase_start=False):
    new_ids, counts = compact_round(cols, vals_m, nvalid, prices, owner,
                                    sigma, ids, eps, bigp,
                                    phase_start=phase_start, keys=keys)
    won, evicted, stayed = counts.tolist()     # the round's one sync
    return new_ids, won, evicted, stayed


def tier_ladder(cols, vals_m, nvalid, prices, owner, sigma, ids, active,
                rounds, eps, *, bigp, tiers, threshold=0, max_iter,
                tier_rounds, keys=None):
    """Descend the tier ladder at fixed eps: rounds at capacity C while
    ``active`` exceeds max(next tier, threshold) and the round budget
    lasts.  ``ids`` is an ascending compacted buffer of capacity tiers[0].
    ``tier_rounds`` is updated in place.  Returns (ids, active, rounds)."""
    for ti, C in enumerate(tiers):
        floor_static = tiers[ti + 1] if ti + 1 < len(tiers) else 0
        if C != tiers[0]:
            # live ids are the ascending prefix; the previous tier's exit
            # condition left active <= C
            ids = ids[:C]
        before = rounds
        while active > max(floor_static, threshold) and rounds < max_iter:
            ids, won, evicted, _ = _round(cols, vals_m, nvalid, prices,
                                          owner, sigma, ids, eps, bigp, keys)
            active = active - won + evicted
            rounds += 1
        tier_rounds[ti + 1] += rounds - before
    return ids, active, rounds


def solve_tiered(cols, vals_m, nvalid, p0, eps0, eps_min, theta, max_iter,
                 *, bigp, tiers: Optional[Tuple[int, ...]] = None, trunc=0,
                 init_state: Optional[TieredState] = None,
                 max_phases: Optional[int] = None, theta_tail=None,
                 tail_phases: int = 2, wide: bool = False):
    """eps-scaled tiered solve for square effective problems, over the
    plain per-row layout on one device (the reference's
    ``solve_rowpack_tiered``).  ``trunc`` > 0 truncates every phase once
    <= trunc rows are active (the hybrid's host finisher completes the
    assignment).  ``max_phases`` bounds the phases run in this call; pass
    the returned TieredState back as ``init_state`` to continue.

    ``wide``: after each phase start, keep running full-width rounds
    (capacity n) while more than 2n/5 rows are active, counted in
    tier_rounds[0].  This is the reference's wide loop (run there with its
    window-gather layout): its rounds bid all unassigned biddable rows,
    which is exactly the set the compacted buffer holds, so trajectories
    are unchanged and only the round partition moves.

    Returns (SolveResult, TieredState)."""
    n = nvalid.shape[0]
    m = p0.shape[0]
    device = p0.device
    dt = _auction.numpy_dtype(vals_m.dtype).type
    if tiers is None:
        tiers = default_tiers(n)
    if tiers[0] != n:
        raise ValueError("top tier must cover all rows")
    bigp = dt(bigp)
    eps_min = dt(eps_min)
    eps0 = np.maximum(dt(eps0), eps_min)
    theta = dt(theta)
    max_iter = int(max_iter)
    all_rows = torch.arange(n, dtype=torch.int32, device=device)
    keys = (torch.zeros(m, dtype=torch.int64, device=device)
            if device.type == "cuda" else None)

    def run_phase(st: TieredState, first: bool) -> None:
        sigma = st.sigma
        if first:
            ids = torch.where(nvalid > 0, all_rows, n)
        else:
            ids = torch.where(((sigma < 0) & (nvalid > 0)) | (sigma >= 0),
                              all_rows, n)
        ids, _, evicted, stayed = _round(
            cols, vals_m, nvalid, st.prices, st.owner, sigma,
            ids.to(torch.int32), st.eps, bigp, keys, phase_start=not first)
        st.rounds += 1
        st.tier_rounds[0] += 1
        active = stayed + evicted
        if wide:
            wide_floor = (2 * n) // 5
            before = st.rounds
            while active > wide_floor and st.rounds < max_iter:
                ids, won, evicted, _ = _round(
                    cols, vals_m, nvalid, st.prices, st.owner, sigma, ids,
                    st.eps, bigp, keys)
                active = active - won + evicted
                st.rounds += 1
            st.tier_rounds[0] += st.rounds - before
        _, _, st.rounds = tier_ladder(
            cols, vals_m, nvalid, st.prices, st.owner, sigma, ids, active,
            st.rounds, st.eps, bigp=bigp, tiers=tiers, threshold=int(trunc),
            max_iter=max_iter, tier_rounds=st.tier_rounds, keys=keys)
        st.phases += 1

    if init_state is None:
        st = TieredState(
            prices=p0.to(vals_m.dtype, copy=True),
            owner=torch.full((m,), -1, dtype=torch.int32, device=device),
            sigma=torch.full((n,), -1, dtype=torch.int32, device=device),
            eps=eps0, rounds=0, phases=0,
            tier_rounds=[0] * (len(tiers) + 1))
        run_phase(st, first=True)
    else:
        st = dataclasses.replace(
            init_state,
            prices=init_state.prices.to(device=device, dtype=vals_m.dtype,
                                        copy=True),
            owner=init_state.owner.to(device=device, copy=True),
            sigma=init_state.sigma.to(device=device, copy=True),
            eps=dt(init_state.eps),
            tier_rounds=list(init_state.tier_rounds))
    budget = 2 ** 30 if max_phases is None else st.phases + int(max_phases)
    done = st.eps <= eps_min or st.rounds >= max_iter
    while not done and st.phases < budget:
        st.eps = _auction._next_eps(st.eps, theta, eps_min,
                                    theta_tail=theta_tail,
                                    tail_phases=tail_phases)
        run_phase(st, first=False)
        done = st.eps <= eps_min or st.rounds >= max_iter
    unassigned = int(_auction.count_unassigned(st.sigma, nvalid))
    res = _auction.SolveResult(sigma=st.sigma, prices=st.prices,
                               rounds=st.rounds, phases=st.phases,
                               final_eps=st.eps, unassigned=unassigned)
    return res, st


def solve_ell_tiered(cols, vals_t, valid, nvalid, p0, eps0, eps_min, theta,
                     max_iter, *, tiers=None, bigp=None, trunc=0,
                     init_state=None, max_phases=None, theta_tail=None,
                     tail_phases: int = 2, wide: bool = False):
    """``solve_tiered`` over ELL tensors with transformed values and a
    validity mask (the reference's ``solve_ell_tiered``): masks the
    padding and, when ``bigp`` is None, derives it from the value range in
    the solver dtype."""
    if bigp is None:
        bigp = _auction.value_bigp(vals_t, valid)
    return solve_tiered(cols, _auction.mask_vals(vals_t, valid), nvalid, p0,
                        eps0, eps_min, theta, max_iter, bigp=bigp, tiers=tiers,
                        trunc=trunc, init_state=init_state,
                        max_phases=max_phases, theta_tail=theta_tail,
                        tail_phases=tail_phases, wide=wide)
