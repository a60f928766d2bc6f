"""K2: resolve + commit of a compacted round.

Replaces ``sslap_tpu/ops/commit.py::_commit_kernel`` (Pallas sequential
max-scatter of bids into per-column (best, winner), contract
``auction.resolve_bids``) and also applies the commit of
``sslap_tpu/compact.py::compact_round``: the winner's bid becomes the
column's price, the winner its owner, and the previous owner is evicted.
The kernel is ``csrc/commit.cu``: two launches, a resolve (one 64-bit
atomicMax on an order-preserving (bid, row) key per column a warp
touches), then a commit; its note says what bounds it on the card.
``commit_plain`` is the same function as torch ops around
``auction.resolve_bids`` (scatter-reduce amax, then amin).

``commit`` dispatches by device: a CPU tensor goes to the twin, a CUDA
tensor launches the kernel (or raises), and nothing falls back.
"""

from __future__ import annotations

import numpy as np
import torch

from sslap_tpu_torch.auction import I32_MAX, resolve_bids
from sslap_tpu_torch.ops import _build


def commit_plain(ids, tgt, bid, prices, owner, sigma):
    """Plain torch twin of the kernel; same arguments (less the kernel's
    ``keys`` scratch) and results.

    ids [C] int32 (pad = n); tgt [C] int32 (m = no bid); bid [C].
    ``prices``, ``owner`` and ``sigma`` are updated IN PLACE.  Returns
    (stay [C]: losing bidders, else n; evicted [C]: previous owners of won
    columns, else n; counts [3] int32: won, evicted, stayed)."""
    n = sigma.shape[0]
    m = prices.shape[0]
    bidding = tgt < m
    _, winner = resolve_bids(tgt, bid, m, ids)
    t = tgt.long()
    won = torch.cat([winner, winner.new_full((1,), I32_MAX)])[t] == ids
    prev = torch.where(won, owner[t.clamp(max=m - 1)], -1)
    wt = t[won]
    # In place: won columns are unique, and an evictee is assigned, so it
    # is never a bidder of this round.
    prices[wt] = bid[won]
    owner[wt] = ids[won]
    sigma[ids[won].long()] = tgt[won]
    sigma[prev[prev >= 0].long()] = -1
    lost = bidding & ~won
    stay = torch.where(lost, ids, n).to(torch.int32)
    evicted = torch.where(prev >= 0, prev, n).to(torch.int32)
    counts = torch.stack([won.sum(), (prev >= 0).sum(), lost.sum()])
    return stay, evicted, counts.to(torch.int32)


def commit(ids, tgt, bid, prices, owner, sigma, keys=None):
    """K2: see ``commit_plain`` for the contract.  CUDA tensors launch
    ``csrc/commit.cu``; ``keys`` is its [m] int64 scratch, all zero on
    entry and left all zero (allocated here when not given)."""
    if ids.device.type == "cpu":
        return commit_plain(ids, tgt, bid, prices, owner, sigma)
    if ids.device.type != "cuda":
        raise RuntimeError(f"commit: unsupported device {ids.device}")
    dtype = prices.dtype
    if dtype not in (torch.float32, torch.int32):
        raise TypeError(f"commit: unsupported dtype {dtype}")
    n = sigma.shape[0]
    m = prices.shape[0]
    C = ids.shape[0]
    if keys is None:
        keys = torch.zeros(m, dtype=torch.int64, device=ids.device)
    for name, t, dt, shape in (
            ("ids", ids, torch.int32, (C,)), ("tgt", tgt, torch.int32, (C,)),
            ("bid", bid, dtype, (C,)), ("owner", owner, torch.int32, (m,)),
            ("sigma", sigma, torch.int32, (n,)),
            ("keys", keys, torch.int64, (m,))):
        if t.device != ids.device or t.dtype != dt or \
                not t.is_contiguous() or t.shape != shape:
            raise ValueError(f"commit: {name} must be a contiguous {dt} "
                             f"tensor of shape {shape} on {ids.device}")
    if not prices.is_contiguous() or prices.device != ids.device:
        raise ValueError("commit: prices must be contiguous on the device")
    lib = _build.load()
    stay = torch.empty(C, dtype=torch.int32, device=ids.device)
    evicted = torch.empty(C, dtype=torch.int32, device=ids.device)
    counts = torch.empty(3, dtype=torch.int32, device=ids.device)
    fn = (lib.sslap_commit_f32 if dtype == torch.float32
          else lib.sslap_commit_i32)
    err = fn(ids.data_ptr(), tgt.data_ptr(), bid.data_ptr(), C, n, m,
             keys.data_ptr(), prices.data_ptr(), owner.data_ptr(),
             sigma.data_ptr(), stay.data_ptr(), evicted.data_ptr(),
             counts.data_ptr(),
             torch.cuda.current_stream(ids.device).cuda_stream)
    _build.check(err, "commit")
    commit.launches += 1
    return stay, evicted, counts


commit.launches = 0


def bid_key_np(bid: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Host mirror of the kernel's resolve key (``csrc/commit.cu``):
    (order-preserving uint32 of the bid) << 32 | (0xFFFFFFFF - row), so
    that a larger key is a higher bid, then a lower row.  -0.0 is keyed as
    +0.0."""
    bid = np.asarray(bid)
    if bid.dtype == np.float32:
        u = np.where(bid == 0, np.float32(0), bid).view(np.uint32)
        hi = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    elif bid.dtype == np.int32:
        hi = bid.view(np.uint32) ^ np.uint32(0x80000000)
    else:
        raise TypeError(f"unsupported bid dtype {bid.dtype}")
    lo = np.uint64(0xFFFFFFFF) - np.asarray(rows).astype(np.uint64)
    return (hi.astype(np.uint64) << np.uint64(32)) | lo


def bid_key_decode_np(keys: np.ndarray, dtype):
    """Inverse of ``bid_key_np``: (bid, row)."""
    keys = np.asarray(keys, np.uint64)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    rows = (np.uint64(0xFFFFFFFF) - (keys & np.uint64(0xFFFFFFFF))) \
        .astype(np.int64)
    if np.dtype(dtype) == np.float32:
        u = np.where(hi & np.uint32(0x80000000), hi ^ np.uint32(0x80000000),
                     ~hi)
        return u.view(np.float32), rows
    return (hi ^ np.uint32(0x80000000)).view(np.int32), rows
