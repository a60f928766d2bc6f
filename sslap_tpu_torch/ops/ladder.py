"""The eps-phase ladder: one eps phase of the square tiered solve -- the
phase-start round, the wide loop and the tier ladder -- as one op.

Redesigns K1 (``sslap_tpu/ops/bid.py::_bid_kernel``) and K2
(``sslap_tpu/ops/commit.py::_commit_kernel``) for the square tiered solve:
the kernel, ``csrc/ladder.cu``, is one persistent cooperative launch per
phase whose rounds are K1's bid + K2's resolve, a grid barrier, K2's
commit + an in-kernel relist, a grid barrier, with the loop control on the
device and the narrow tail in one block (its note says what bounds it and
how).  The reference runs the phase as one device program
(``sslap_tpu/compact.py::solve_rowpack_tiered``).

``ladder_phase_plain`` is the same phase as a host loop over
``compact_round`` (K1's and K2's plain versions and a torch sort for the
relist), one count read back per round; the CPU path runs it.

``ladder_phase`` dispatches by device: a CPU tensor goes to the plain
version, a CUDA tensor launches the kernel (or raises), and nothing falls
back.  Either way ``prices``, ``owner`` and ``sigma`` are updated in place
and (rounds, active, hist) comes back: the round count after the phase,
the rows still active, and the rounds by tier (``TieredState.tier_rounds``
layout: 0 the full-width rounds, 1 + i the ladder rounds at tiers[i]).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from sslap_tpu_torch.auction import half_neg, neg_sentinel
from sslap_tpu_torch.ops import _build
from sslap_tpu_torch.ops.bid import _scalar, bid_topk, bid_topk_plain
from sslap_tpu_torch.ops.commit import commit, commit_plain

MAX_TIERS = 63      # tiers the kernel's histogram holds
_FIXED = 8          # out[]: rounds, active, grid/tail rounds, grid/tail ns,
                    # grid/tail stage A ns


def compact_round(cols, vals_m, nvalid, prices, owner, sigma, ids, eps, bigp,
                  *, phase_start: bool = False):
    """One auction round over the compacted active set ``ids`` (pad = n),
    on the kernels' plain versions (any device).

    ``prices``, ``owner`` and ``sigma`` are updated IN PLACE.  With
    ``phase_start``, assigned rows in ``ids`` that violate eps-CS at
    ``eps`` are unassigned and bid in this round; otherwise every live id
    is an unassigned row by invariant.

    Returns (new_ids [C] ascending, pad = n; counts [3] int32: won,
    evicted, stayed)."""
    tgt, bid = bid_topk_plain(ids, cols, vals_m, nvalid, prices, sigma,
                              owner, eps, bigp, phase_start=phase_start)
    stay, evicted, counts = commit_plain(ids, tgt, bid, prices, owner, sigma)
    new_ids = torch.sort(torch.cat([stay, evicted])).values[:ids.shape[0]]
    return new_ids, counts


def kernel_round(cols, vals_m, nvalid, prices, owner, sigma, ids, eps, bigp,
                 keys=None):
    """``compact_round`` (no phase start) through the dispatching wrappers:
    K1 (``bid_topk``) and K2 (``commit``, ``keys`` its [m] int64 scratch)
    launch on CUDA tensors and run their plain versions on the CPU, so the
    result is ``compact_round``'s either way.  The candidate engine's
    compact tiers run it."""
    tgt, bid = bid_topk(ids, cols, vals_m, nvalid, prices, sigma, owner, eps,
                        bigp)
    stay, evicted, counts = commit(ids, tgt, bid, prices, owner, sigma, keys)
    new_ids = torch.sort(torch.cat([stay, evicted])).values[:ids.shape[0]]
    return new_ids, counts


def _round(cols, vals_m, nvalid, prices, owner, sigma, ids, eps, bigp,
           phase_start=False):
    new_ids, counts = compact_round(cols, vals_m, nvalid, prices, owner,
                                    sigma, ids, eps, bigp,
                                    phase_start=phase_start)
    won, evicted, stayed = counts.tolist()     # the round's one sync
    return new_ids, won, evicted, stayed


def ladder_phase_plain(cols, vals_m, nvalid, prices, owner, sigma, eps, bigp,
                       *, first: bool, wide: bool, tiers: Sequence[int],
                       threshold: int, max_iter: int, rounds: int,
                       scratch=None) -> Tuple[int, int, List[int]]:
    """The plain version of ``ladder_phase`` (same arguments and results;
    ``scratch`` is the kernel's and unused here): the phase-start round
    over all rows (``first``: the biddable ones, no violator scan), then,
    with ``wide``, full-width rounds while more than 2n/5 rows are active,
    then the tier ladder: rounds at capacity tiers[i] while the active
    count exceeds max(tiers[i + 1] or 0, threshold), all while rounds <
    max_iter.  The live ids stay an ascending prefix, so each tier narrows
    the buffer by slicing."""
    n = nvalid.shape[0]
    hist = [0] * (len(tiers) + 1)
    all_rows = torch.arange(n, dtype=torch.int32, device=nvalid.device)
    if first:
        ids = torch.where(nvalid > 0, all_rows, n)
    else:
        ids = torch.where(((sigma < 0) & (nvalid > 0)) | (sigma >= 0),
                          all_rows, n)
    ids, _, evicted, stayed = _round(cols, vals_m, nvalid, prices, owner,
                                     sigma, ids.to(torch.int32), eps, bigp,
                                     phase_start=not first)
    rounds += 1
    hist[0] += 1
    active = stayed + evicted
    if wide:
        wide_floor = (2 * n) // 5
        while active > wide_floor and rounds < max_iter:
            ids, won, evicted, _ = _round(cols, vals_m, nvalid, prices,
                                          owner, sigma, ids, eps, bigp)
            active = active - won + evicted
            rounds += 1
            hist[0] += 1
    for ti, C in enumerate(tiers):
        floor_static = tiers[ti + 1] if ti + 1 < len(tiers) else 0
        if C != tiers[0]:
            # the previous tier's exit condition left active <= C
            ids = ids[:C]
        while active > max(floor_static, threshold) and rounds < max_iter:
            ids, won, evicted, _ = _round(cols, vals_m, nvalid, prices,
                                          owner, sigma, ids, eps, bigp)
            active = active - won + evicted
            rounds += 1
            hist[ti + 1] += 1
    return rounds, active, hist


@dataclasses.dataclass
class LadderScratch:
    """The kernel's device buffers, made once per solve (``make_scratch``)
    and reused by every phase: ``keys`` [m] int64 (all zero between
    rounds), ``ids`` [2, n] int32, per-slot ``tgt`` [n] int32 and ``bid``
    [n], ``ctrl`` (barrier and append counters, zero at first use),
    ``tiers`` [len(tiers)] int32 and ``out`` [8 + len(tiers) + 1] int64."""
    keys: torch.Tensor
    ids: torch.Tensor
    tgt: torch.Tensor
    bid: torch.Tensor
    ctrl: torch.Tensor
    tiers: torch.Tensor
    out: torch.Tensor
    tiers_key: Tuple[int, ...]


def make_scratch(n: int, m: int, dtype: torch.dtype, tiers: Sequence[int],
                 device) -> LadderScratch:
    device = torch.device(device)
    return LadderScratch(
        keys=torch.zeros(m, dtype=torch.int64, device=device),
        ids=torch.empty((2, n), dtype=torch.int32, device=device),
        tgt=torch.empty(n, dtype=torch.int32, device=device),
        bid=torch.empty(n, dtype=dtype, device=device),
        ctrl=torch.zeros(8, dtype=torch.int32, device=device),
        tiers=torch.tensor(list(tiers), dtype=torch.int32, device=device),
        out=torch.zeros(_FIXED + len(tiers) + 1, dtype=torch.int64,
                        device=device),
        tiers_key=tuple(int(t) for t in tiers))


def _check(cols, vals_m, nvalid, prices, owner, sigma, tiers):
    """Raise on arguments the kernel does not take (both paths check, so
    the CPU path refuses what a CUDA call would)."""
    n, K = cols.shape
    m = prices.shape[0]
    dtype = vals_m.dtype
    if dtype not in (torch.float32, torch.int32):
        raise TypeError(f"ladder_phase: unsupported dtype {dtype}")
    for name, t, dt, shape in (
            ("cols", cols, torch.int32, (n, K)),
            ("vals_m", vals_m, dtype, (n, K)),
            ("nvalid", nvalid, torch.int32, (n,)),
            ("prices", prices, dtype, (m,)),
            ("owner", owner, torch.int32, (m,)),
            ("sigma", sigma, torch.int32, (n,))):
        if t.device != cols.device or t.dtype != dt or \
                not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"ladder_phase: {name} must be a contiguous {dt}"
                             f" tensor of shape {shape} on {cols.device}")
    if cols.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"ladder_phase: unsupported device {cols.device}")
    if not tiers or tiers[0] != n or len(tiers) > MAX_TIERS or \
            list(tiers) != sorted(tiers, reverse=True):
        raise ValueError(f"ladder_phase: tiers must descend from n = {n}, "
                         f"at most {MAX_TIERS} of them")


def ladder_phase(cols, vals_m, nvalid, prices, owner, sigma, eps, bigp, *,
                 first: bool, wide: bool, tiers: Sequence[int],
                 threshold: int, max_iter: int, rounds: int,
                 scratch: Optional[LadderScratch] = None
                 ) -> Tuple[int, int, List[int]]:
    """One eps phase; see ``ladder_phase_plain`` for the contract.  CPU
    tensors run the plain version; CUDA tensors make one cooperative launch
    of ``csrc/ladder.cu`` on the current stream and read back one small
    array (``scratch`` from ``make_scratch``, allocated here when not
    given)."""
    _check(cols, vals_m, nvalid, prices, owner, sigma, tiers)
    kw = dict(first=first, wide=wide, tiers=tiers, threshold=threshold,
              max_iter=max_iter, rounds=rounds)
    if cols.device.type == "cpu":
        return ladder_phase_plain(cols, vals_m, nvalid, prices, owner, sigma,
                                  eps, bigp, **kw)
    n, K = cols.shape
    m = prices.shape[0]
    dtype = vals_m.dtype
    if scratch is None:
        scratch = make_scratch(n, m, dtype, tiers, cols.device)
    if scratch.tiers_key != tuple(int(t) for t in tiers) or \
            scratch.keys.shape != (m,) or scratch.bid.dtype != dtype or \
            scratch.ids.shape != (2, n) or scratch.keys.device != cols.device:
        raise ValueError("ladder_phase: scratch was made for another problem")
    lib = _build.load()
    fn = (lib.sslap_ladder_f32 if dtype == torch.float32
          else lib.sslap_ladder_i32)
    s = scratch
    err = fn(cols.data_ptr(), vals_m.data_ptr(), nvalid.data_ptr(),
             prices.data_ptr(), owner.data_ptr(), sigma.data_ptr(),
             s.keys.data_ptr(), s.ids[0].data_ptr(), s.ids[1].data_ptr(),
             s.tgt.data_ptr(), s.bid.data_ptr(), s.ctrl.data_ptr(),
             s.tiers.data_ptr(), len(tiers), n, m, K, _scalar(eps, dtype),
             _scalar(bigp, dtype), neg_sentinel(dtype), half_neg(dtype),
             int(first), int(wide), int(threshold), int(rounds),
             int(max_iter), s.out.data_ptr(),
             torch.cuda.current_stream(cols.device).cuda_stream)
    _build.check(err, "ladder_phase")
    ladder_phase.launches += 1
    out = s.out.tolist()                       # the phase's one sync
    st = ladder_phase.stats
    st["grid_rounds"] += out[2]
    st["tail_rounds"] += out[3]
    st["grid_ns"] += out[4]
    st["tail_ns"] += out[5]
    st["grid_a_ns"] += out[6]
    st["tail_a_ns"] += out[7]
    return out[0], out[1], out[_FIXED:]


ladder_phase.launches = 0
# Rounds and device nanoseconds (%globaltimer in block 0) of the kernel's
# launches, split at the one-block tail (grid rounds include the phase
# start and the wide loop), and the stage A (bid + resolve) part of each
# side's ns.  Reset by the caller, like ``launches``.
ladder_phase.stats = dict(grid_rounds=0, tail_rounds=0, grid_ns=0, tail_ns=0,
                          grid_a_ns=0, tail_a_ns=0)
