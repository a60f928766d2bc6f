"""Tiered active-row-compacted auction solve (the device half of the
square hybrid).  Counterpart of ``sslap_tpu/compact.py``.

An eps phase is one op, ``ops.ladder_phase``: a full-width round that
doubles as the eps-CS violator scan, the wide loop, then the tier ladder,
whose rounds run over the compacted active set (the unassigned, biddable
rows; it never grows within a phase, so tiers only step down):

  bid      K1's arithmetic: top-2 over K per active row, bid
  resolve  K2's: per column the highest bid, lowest row wins
  commit   K2's: price raise, owner install, eviction (in place)
  relist   new actives = losers + evicted

On a CUDA device the whole phase is one persistent kernel launch
(``ops/csrc/ladder.cu``) with the loop control on the device, and one
small read back per phase (rounds, active count, tier histogram).  On the
CPU it is the plain host loop (``ops.ladder.ladder_phase_plain``: one
count read back per round, a torch sort for the relist).  Either way the
round partition is exactly the reference's.  The per-row data is a plain
layout, ``cols [n, K]`` int32 / ``vals_m [n, K]`` (padding = neg
sentinel) / ``nvalid [n]``: the reference's 128-lane line packing
(RowPack) and its all-pairs narrow-tier resolve are TPU workarounds with
no job here.

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
from sslap_tpu_torch.ops.ladder import compact_round  # noqa: F401 (API)
from sslap_tpu_torch.ops.ladder import ladder_phase, make_scratch


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
    scratch = (make_scratch(n, m, vals_m.dtype, tiers, device)
               if device.type == "cuda" else None)

    def run_phase(st: TieredState, first: bool) -> None:
        st.rounds, _, hist = ladder_phase(
            cols, vals_m, nvalid, st.prices, st.owner, st.sigma, st.eps,
            bigp, first=first, wide=wide, tiers=tiers, threshold=int(trunc),
            max_iter=max_iter, rounds=st.rounds, scratch=scratch)
        st.tier_rounds = [a + b for a, b in zip(st.tier_rounds, hist)]
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
    unassigned = int(_auction.count_unassigned_rows(st.sigma, nvalid))
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
