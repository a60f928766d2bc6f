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
``auction.resolve_bids`` (scatter-reduce amax, then amin).  With a row
offset, both commit the bids that every shard of the sharded hybrid
all-gathered (``parallel/sharded_compact.py``): row ids are global, each
shard keeps the same price and owner replicas, and its sigma holds only
its own rows.

``resolve`` is the kernel's first launch alone, for the sharded and
overlapped rounds (``parallel/``): a shard folds its bids into its [m]
key table, and the shards' tables are combined by one elementwise max
(an all-reduce with bit 63 flipped: ``KEY_FLIP``), whose decoding
(``decode_keys``) is the reference's combined (best, winner).
``resolve_plain`` is the same as torch ops: the keys of ``bid_key_np``'s
rule, a scatter max per column.

``commit_keys`` is the sharded and overlapped rounds' commit, fused
into one launch of ``csrc/commit.cu`` (no Pallas kernel behind it: it
replaces the XLA jnp decode and commit of ``sslap_tpu/auction.py``'s
``commit_bids`` and the guarded commit of
``sslap_tpu/parallel/overlap.py:95-108``): per column of the combined
key table that holds a bid, decode (best, winner), accept it (always, or
guarded: if it clears the price by eps), evict the old owner and install
the winner where their rows are the shard's, and zero the key.
``commit_keys_plain`` is ``decode_keys`` then ``auction.commit_bids``.

``commit``, ``resolve`` and ``commit_keys`` dispatch by device: a CPU
tensor goes to the twin, a CUDA tensor launches the kernel (or raises),
and nothing falls back.
"""

from __future__ import annotations

import numpy as np
import torch

from sslap_tpu_torch import auction as _auction
from sslap_tpu_torch.auction import I32_MAX, half_neg, neg_sentinel, \
    resolve_bids
from sslap_tpu_torch.ops import _build

# A key's bit 63 flipped: its unsigned order is then the signed int64
# order, so torch's signed max and scatter max compare keys as the kernel's
# unsigned atomicMax does (the key of every non-negative bid has bit 63
# set).
KEY_FLIP = -2 ** 63


def commit_plain(ids, tgt, bid, prices, owner, sigma, row_offset=0,
                 n_rows=None):
    """Plain torch twin of the kernel; same arguments (less the kernel's
    ``keys`` scratch) and results.

    ids [C] int32 global row ids (pad = n_rows); tgt [C] int32 (m = no
    bid); bid [C].  ``sigma`` holds rows [row_offset, row_offset +
    sigma.shape[0]) (all n rows by default): a row outside them is another
    shard's, whose sigma is left alone (K2 over the bids every shard
    all-gathered, ``parallel/sharded_compact.py``); ``n_rows`` (default
    row_offset + sigma.shape[0]) is the pad value of the outputs.
    ``prices``, ``owner`` and ``sigma`` are updated IN PLACE.  Returns
    (stay [C]: losing bidders, else n_rows; evicted [C]: previous owners of
    won columns, else n_rows; counts [3] int32: won, evicted, stayed), row
    ids global."""
    n = sigma.shape[0]
    n_rows = row_offset + n if n_rows is None else n_rows
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
    sig = torch.cat([sigma, sigma.new_full((1,), -1)])   # slot n: not ours
    sig[_auction._local_rows(ids, won, row_offset, n)] = tgt
    sig[_auction._local_rows(prev, prev >= 0, row_offset, n)] = -1
    sigma.copy_(sig[:n])
    lost = bidding & ~won
    stay = torch.where(lost, ids, n_rows).to(torch.int32)
    evicted = torch.where(prev >= 0, prev, n_rows).to(torch.int32)
    counts = torch.stack([won.sum(), (prev >= 0).sum(), lost.sum()])
    return stay, evicted, counts.to(torch.int32)


def commit(ids, tgt, bid, prices, owner, sigma, keys=None, row_offset=0,
           n_rows=None):
    """K2: see ``commit_plain`` for the contract.  CUDA tensors launch
    ``csrc/commit.cu``; ``keys`` is its [m] int64 scratch, all zero on
    entry and left all zero (allocated here when not given)."""
    if ids.device.type == "cpu":
        return commit_plain(ids, tgt, bid, prices, owner, sigma, row_offset,
                            n_rows)
    if ids.device.type != "cuda":
        raise RuntimeError(f"commit: unsupported device {ids.device}")
    dtype = prices.dtype
    if dtype not in (torch.float32, torch.int32):
        raise TypeError(f"commit: unsupported dtype {dtype}")
    n = sigma.shape[0]
    n_rows = row_offset + n if n_rows is None else n_rows
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
    if row_offset < 0 or not row_offset + n <= n_rows < 2 ** 31:
        raise ValueError("commit: the shard's rows must lie in [0, n_rows)")
    lib = _build.load()
    stay = torch.empty(C, dtype=torch.int32, device=ids.device)
    evicted = torch.empty(C, dtype=torch.int32, device=ids.device)
    counts = torch.empty(3, dtype=torch.int32, device=ids.device)
    fn = (lib.sslap_commit_f32 if dtype == torch.float32
          else lib.sslap_commit_i32)
    err = fn(ids.data_ptr(), tgt.data_ptr(), bid.data_ptr(), C, n_rows, m,
             keys.data_ptr(), prices.data_ptr(), owner.data_ptr(),
             sigma.data_ptr(), int(row_offset), n, stay.data_ptr(),
             evicted.data_ptr(), counts.data_ptr(),
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


def _flipped_keys(bid: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """int64 keys of ``bid_key_np``'s rule with bit 63 flipped:
    (order bits - 2**31) * 2**32 + (2**32 - 1 - row)."""
    if bid.dtype == torch.float32:
        u = (bid + 0).view(torch.int32).long() & 0xFFFFFFFF  # -0.0 -> +0.0
        order = torch.where(u >= 2 ** 31, 0xFFFFFFFF - u, u + 2 ** 31)
    elif bid.dtype == torch.int32:
        order = bid.long() + 2 ** 31
    else:
        raise TypeError(f"unsupported bid dtype {bid.dtype}")
    return (order - 2 ** 31) * 2 ** 32 + (0xFFFFFFFF - rows.long())


def resolve_plain(ids, tgt, bid, keys):
    """Plain torch twin of the resolve launch: every bid (tgt < m) folded
    into ``keys`` [m] int64 (the kernel's unsigned keys, 0 = no bid) by a
    max per column, IN PLACE.  ids [C] int32 are the rows the keys carry
    (global ids on a shard); tgt [C] int32 (m = no bid); bid [C]."""
    m = keys.shape[0]
    table = torch.cat([keys ^ KEY_FLIP, keys.new_full((1,), KEY_FLIP)])
    table.scatter_reduce_(0, tgt.long(), _flipped_keys(bid, ids), "amax")
    keys.copy_(table[:m] ^ KEY_FLIP)
    return keys


def resolve(ids, tgt, bid, keys):
    """K2's resolve launch alone: see ``resolve_plain`` for the contract.
    CUDA tensors launch ``csrc/commit.cu``'s resolve kernel; ``keys`` is
    not zeroed after it (the caller does that once it has combined)."""
    if ids.device.type == "cpu":
        return resolve_plain(ids, tgt, bid, keys)
    if ids.device.type != "cuda":
        raise RuntimeError(f"resolve: unsupported device {ids.device}")
    dtype = bid.dtype
    if dtype not in (torch.float32, torch.int32):
        raise TypeError(f"resolve: unsupported dtype {dtype}")
    C = ids.shape[0]
    m = keys.shape[0]
    for name, t, dt, shape in (
            ("ids", ids, torch.int32, (C,)), ("tgt", tgt, torch.int32, (C,)),
            ("bid", bid, dtype, (C,)), ("keys", keys, torch.int64, (m,))):
        if t.device != ids.device or t.dtype != dt or \
                not t.is_contiguous() or t.shape != shape:
            raise ValueError(f"resolve: {name} must be a contiguous {dt} "
                             f"tensor of shape {shape} on {ids.device}")
    lib = _build.load()
    fn = (lib.sslap_resolve_f32 if dtype == torch.float32
          else lib.sslap_resolve_i32)
    err = fn(ids.data_ptr(), tgt.data_ptr(), bid.data_ptr(), C, m,
             keys.data_ptr(),
             torch.cuda.current_stream(ids.device).cuda_stream)
    _build.check(err, "resolve")
    resolve.launches += 1
    return keys


resolve.launches = 0


def decode_keys(keys: torch.Tensor, dtype: torch.dtype):
    """(best [m] in ``dtype``, winner [m] int32) of a key table: the neg
    sentinel and INT32_MAX where no bid landed, as ``auction.resolve_bids``
    leaves them.  A zero bid decodes as +0.0 (keys canonicalise -0.0)."""
    has = keys != 0
    hi = (keys >> 32) & 0xFFFFFFFF
    winner = torch.where(has, 0xFFFFFFFF - (keys & 0xFFFFFFFF), I32_MAX)
    if dtype == torch.float32:
        bits = torch.where(hi >= 2 ** 31, hi - 2 ** 31, 0xFFFFFFFF - hi)
    elif dtype == torch.int32:
        bits = hi ^ 2 ** 31
    else:
        raise TypeError(f"unsupported bid dtype {dtype}")
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    best = bits.to(torch.int32).view(dtype)
    best = torch.where(has, best, torch.full_like(best, neg_sentinel(dtype)))
    return best, winner.to(torch.int32)


def commit_keys_plain(keys, prices, owner, sigma, row_offset=0, eps=None):
    """Plain torch twin of the fused key commit: ``decode_keys`` of the
    combined [m] int64 ``keys``, then ``auction.commit_bids`` on this
    shard's replicas ``prices`` and ``owner`` [m] and its rows ``sigma``
    (global ids ``row_offset`` + index), guarded when ``eps`` is given.
    ``prices``, ``owner`` and ``sigma`` are updated IN PLACE and ``keys``
    is zeroed; returns (prices, owner, sigma).

    The kernel commits each column in one pass, which equals the twin's
    every-eviction-before-any-assignment only when no row is both evicted
    and assigned in one commit.  The solvers promise that (a winner was
    unassigned when it bid, and the overlapped round's pending rows do not
    bid again); the twin checks it and raises where it breaks."""
    best, winner = decode_keys(keys, prices.dtype)
    if eps is None:
        acc = best > half_neg(prices.dtype)
    else:
        acc = (winner != I32_MAX) & (best >= prices + eps)
    evicted = owner[acc & (owner >= 0)]
    if torch.isin(winner[acc], evicted).any():
        raise RuntimeError("commit_keys: a row is both evicted and assigned "
                           "in one commit")
    p, o, s = _auction.commit_bids(best, winner, prices, owner, sigma,
                                   row_offset, eps=eps)
    prices.copy_(p)
    owner.copy_(o)
    sigma.copy_(s)
    keys.zero_()
    return prices, owner, sigma


def commit_keys(keys, prices, owner, sigma, row_offset=0, eps=None):
    """The fused key commit: see ``commit_keys_plain`` for the contract.
    CUDA tensors launch ``csrc/commit.cu``'s commit_keys_kernel (four
    columns a thread, in stages)."""
    if keys.device.type == "cpu":
        return commit_keys_plain(keys, prices, owner, sigma, row_offset, eps)
    if keys.device.type != "cuda":
        raise RuntimeError(f"commit_keys: unsupported device {keys.device}")
    dtype = prices.dtype
    if dtype not in (torch.float32, torch.int32):
        raise TypeError(f"commit_keys: unsupported dtype {dtype}")
    m = keys.shape[0]
    n = sigma.shape[0]
    for name, t, dt, shape in (
            ("keys", keys, torch.int64, (m,)), ("prices", prices, dtype, (m,)),
            ("owner", owner, torch.int32, (m,)),
            ("sigma", sigma, torch.int32, (n,))):
        if t.device != keys.device or t.dtype != dt or \
                not t.is_contiguous() or t.shape != shape:
            raise ValueError(f"commit_keys: {name} must be a contiguous {dt} "
                             f"tensor of shape {shape} on {keys.device}")
    scalar = float if dtype == torch.float32 else int
    lib = _build.load()
    fn = (lib.sslap_commit_keys_f32 if dtype == torch.float32
          else lib.sslap_commit_keys_i32)
    err = fn(keys.data_ptr(), m, prices.data_ptr(), owner.data_ptr(),
             sigma.data_ptr(), n, int(row_offset),
             scalar(0 if eps is None else eps), half_neg(dtype),
             int(eps is not None),
             torch.cuda.current_stream(keys.device).cuda_stream)
    _build.check(err, "commit_keys")
    commit_keys.launches += 1
    return prices, owner, sigma


commit_keys.launches = 0
