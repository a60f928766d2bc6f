"""K3: the serial FIFO Gauss-Seidel auction on the device.

Replaces ``sslap_tpu/ops/gs_kernel.py::_gs_kernel`` (Pallas, entered
through ``gs_auction_device``): pop a row from a ring of unassigned rows,
take the top 2 of ``vals - prices[cols]`` over its ELL slots (ties to the
lowest slot, which is the lowest column), bid ``a* - v2 + eps`` on the
best column, evict its owner to the tail of the ring; stop when the ring
is empty or after ``max_bids`` bids.  The bid semantics are those of the
native ``auction_gs`` (``sslap_tpu/native/sslap_native.cpp``), which is
its oracle.  The kernel is ``csrc/gs.cu``; ``gs_auction_plain`` is the
same function as a plain per-bid loop.

The reference's keyword surface is kept: ``prefetch`` (the kernel loads
the next queued row while the current one bids; no result depends on it)
and the bisect stubs ``_scan="const"`` (bid ``prices[cols[u, 0]] + eps``
on the row's first slot) and ``_scan="noprices"`` (the full top-2 with
every price read as 0).

One rule differs from the TPU kernel on purpose.  The TPU kernel treats a
slot as padding when ``vals <= -bigp``; for a min problem whose costs are
all >= 1 that holds for real entries too (bigp = range + 1 <= -vmin), and
the kernel then bids on padding.  Here padding is what the rest of the
port pads with, the neg sentinel: a slot is real when ``vals >
half_neg(float32)``, so the result is the native engine's on every input.

``gs_auction_device`` dispatches by device: a CPU tensor goes to the plain
twin, a CUDA tensor launches the kernel (or raises), nothing falls back.

On the card ``prefetch=True`` runs the kernel with ``BID_WARPS`` look-ahead
bid warps beside its commit warp (``csrc/gs.cu``, part B); ``prefetch=False``
and the stubs run the commit warp alone.  ``gs_lookahead_mirror`` is that
protocol on the CPU: bid warps reading stale snapshots, in-order validation
against commit stamps and redo, bit for bit the twin's result.
"""

from __future__ import annotations

import numpy as np
import torch

from sslap_tpu_torch.auction import half_neg
from sslap_tpu_torch.ops import _build

NEG = np.float32(-3e38)            # w of a padding slot, as the TPU kernel
_HALF = NEG * np.float32(0.5)      # the TPU kernel's "has a second best"
_REAL_MIN = np.float32(half_neg(torch.float32))   # a slot above it is real
SCANS = {"full": 0, "const": 1, "noprices": 2}   # the C entry's codes
# Look-ahead bid warps beside the commit warp (prefetch=True); the launcher
# takes the most up to this that fit the card's shared memory at the row
# width K (at most 31: one block of 1024 threads).
BID_WARPS = 4
STAMP_BITS = 12          # csrc/gs.cu kStampBits: commit stamps by column hash
COUNTERS = ("speculative", "redone", "single_row_ring")
RING_BUCKETS = ("1", "2-3", "4-15", "16-63", ">=64")


def _prepare(cols, vals_masked, queue, qcount, prices, owner, eps, bigp,
             _scan):
    """The reference's casts (int32 cols/queue/owner, float32 vals/prices
    and scalars), the state copied (the op returns new tables), and the
    ring's preconditions checked."""
    if _scan not in SCANS:
        raise ValueError(f"gs_auction_device: _scan must be one of "
                         f"{sorted(SCANS)}, got {_scan!r}")
    dev = cols.device
    cols = cols.to(dev, torch.int32).contiguous()
    vals = vals_masked.to(dev, torch.float32).contiguous()
    queue = queue.to(dev, torch.int32, copy=True).contiguous()
    prices = prices.to(dev, torch.float32, copy=True).contiguous()
    owner = owner.to(dev, torch.int32, copy=True).contiguous()
    n, K = cols.shape
    cap = queue.shape[0]
    qcount = int(qcount)
    if vals.shape != (n, K) or owner.shape != prices.shape or \
            prices.ndim != 1:
        raise ValueError("gs_auction_device: inconsistent shapes")
    if not 0 <= qcount < cap:
        raise ValueError(f"gs_auction_device: need 0 <= qcount < cap, got "
                         f"qcount={qcount}, cap={cap}")
    if qcount and not bool(((queue[:qcount] >= 0) &
                            (queue[:qcount] < n)).all()):
        raise ValueError("gs_auction_device: queued row ids out of range")
    if owner.numel() and int(owner.max()) >= n:
        raise ValueError("gs_auction_device: owner holds a row id >= n")
    return (cols, vals, queue, qcount, prices, owner, np.float32(eps),
            np.float32(bigp))


def gs_auction_plain(cols, vals_masked, queue, qcount, prices, owner, eps,
                     bigp, max_bids, *, prefetch: bool = True,
                     _scan: str = "full"):
    """Plain twin of the kernel; same arguments and results.

    cols [n, K] int32; vals_masked [n, K] float32 transformed values,
    padding = the neg sentinel; queue [cap] ring whose first ``qcount``
    slots are the rows to run (cap >= n + 1; each row with >= 1 real
    entry); prices [m] float32; owner [m] int32 (-1 free).  Returns new
    (prices, owner, queue) and 0-d int64 tensors (bids done, rows left in
    the ring), on the inputs' device.

    The loop runs one bid at a time on host copies of the tables, in
    numpy float32 scalars (each op the kernel's f32 op, in its order):
    per-op torch dispatch costs ~100 us a bid on a CPU and ~400 us on a
    card, which rules out the probes' 10**6-bid stub runs.  ``prefetch``
    only changes the kernel's timing."""
    del prefetch
    cols, vals, queue, qcount, prices, owner, eps, bigp = _prepare(
        cols, vals_masked, queue, qcount, prices, owner, eps, bigp, _scan)
    dev = cols.device
    c, v = cols.cpu().numpy(), vals.cpu().numpy()
    tables = [t.cpu() for t in (prices, owner, queue)]
    p, o, q = (t.numpy() for t in tables)
    zero = np.float32(0)
    real_min = np.float32(half_neg(torch.float32))
    K, cap = c.shape[1], q.shape[0]
    head, tail, bids = 0, qcount, 0
    with np.errstate(over="ignore"):
        while head != tail and bids < max_bids:
            u = q[head]
            head = 0 if head + 1 == cap else head + 1
            ck, vk = c[u], v[u]
            if _scan == "const":
                j = ck[0]
                bid = (p[j] + zero) + eps
            else:
                v1 = v2 = NEG
                slot = -1
                for k in range(K):
                    a = vk[k] + zero         # the TPU kernel's one-hot reads
                    if a > real_min:
                        w = a - (zero if _scan == "noprices"
                                 else p[ck[k]] + zero)
                    else:
                        w = NEG
                    if w > v1:               # strict: the lowest slot wins
                        v1, v2, slot = w, v1, k
                    elif w > v2:
                        v2 = w
                j, astar = (ck[slot], vk[slot] + zero) if slot >= 0 \
                    else (0, NEG)
                if not v2 > _HALF:
                    v2 = v1 - bigp
                bid = (astar - v2) + eps
            prev = o[j]
            if prev >= 0:
                q[tail] = prev
                tail = 0 if tail + 1 == cap else tail + 1
            p[j] = bid
            o[j] = u
            bids += 1
    left = tail - head if tail >= head else tail - head + cap
    return (*(t.to(dev) for t in tables), torch.tensor(bids, device=dev),
            torch.tensor(left, device=dev))


def _bid_warps(lib, K, dev):
    """The launcher's W: the most bid warps up to ``BID_WARPS`` (and 31)
    whose slots (``2 W (40 + 4 K)`` bytes) and stamps fit the card."""
    limit = lib.sslap_smem_optin(dev.index or 0)
    if limit < 0:
        _build.check(-limit, "gs_auction_device")
    w = max(0, min(int(BID_WARPS), 31))
    while w > 0 and lib.sslap_gs_smem(K, w) > limit:
        w -= 1
    return w


def gs_auction_device(cols, vals_masked, queue, qcount, prices, owner, eps,
                      bigp, max_bids, *, prefetch: bool = True,
                      _scan: str = "full"):
    """K3: see ``gs_auction_plain`` for the contract.  CPU tensors run the
    twin; CUDA tensors launch ``csrc/gs.cu`` on the current stream (with a
    packing pass of prices and owner into an [m] 8-byte table before it
    and an unpacking pass after it).  Runs to ring exhaustion or
    ``max_bids`` bids (infeasible inputs stop there with rows left instead
    of hanging).  ``prefetch`` (no result depends on it) runs the
    look-ahead bid warps beside the commit warp; the stubs run without.
    ``gs_auction_device.stats`` keeps the last launch's [13] int64 device
    tensor (bids, left, then the counters); ``counters()`` reads it."""
    if cols.device.type == "cpu":
        return gs_auction_plain(cols, vals_masked, queue, qcount, prices,
                                owner, eps, bigp, max_bids,
                                prefetch=prefetch, _scan=_scan)
    if cols.device.type != "cuda":
        raise RuntimeError(f"gs_auction_device: unsupported device "
                           f"{cols.device}")
    cols, vals, queue, qcount, prices, owner, eps, bigp = _prepare(
        cols, vals_masked, queue, qcount, prices, owner, eps, bigp, _scan)
    K = cols.shape[1]
    m = prices.shape[0]
    lib = _build.load()
    warps = _bid_warps(lib, K, cols.device) \
        if prefetch and _scan == "full" else 0
    packed = torch.empty(m, dtype=torch.int64, device=cols.device)
    stats = torch.empty(13, dtype=torch.int64, device=cols.device)
    err = lib.sslap_gs_f32(
        cols.data_ptr(), vals.data_ptr(), K, queue.data_ptr(),
        queue.shape[0], qcount, prices.data_ptr(), owner.data_ptr(), m,
        packed.data_ptr(), float(eps), float(bigp), float(NEG), float(_HALF),
        half_neg(torch.float32), int(max_bids), warps, SCANS[_scan],
        stats.data_ptr(), torch.cuda.current_stream(cols.device).cuda_stream)
    _build.check(err, "gs_auction_device")
    gs_auction_device.launches += 1
    gs_auction_device.stats = stats
    gs_auction_device.bid_warps = warps
    return prices, owner, queue, stats[0], stats[1]


def counters(stats=None) -> dict:
    """The kernel's counters from a stats tensor (default: the last
    launch's): bids, rows left, bids committed from a speculative result,
    speculative results redone after a conflict, bids taken with the ring
    holding one row, the ring length at each bid by bucket, and the commit
    warp's clock cycles (clock64) waiting for speculative results, bidding
    itself, and storing and publishing its commits."""
    st = (gs_auction_device.stats if stats is None else stats).tolist()
    return dict(bids=st[0], left=st[1], **dict(zip(COUNTERS, st[2:5])),
                ring=dict(zip(RING_BUCKETS, st[5:10])),
                cycles=dict(zip(("wait", "bid", "commit"), st[10:13])))


gs_auction_device.launches = 0
gs_auction_device.stats = None
gs_auction_device.bid_warps = None
gs_auction_device.counters = counters


def merge_levels(K: int) -> int:
    """Butterfly levels of the kernel's lane merge: ceil(log2(min(K, 32)))
    (slot k sits on lane k mod 32; lanes >= K hold nothing)."""
    levels = 0
    while levels < 5 and (1 << levels) < K:
        levels += 1
    return levels


def _lane_bid(ck, vk, p, o, eps, bigp):
    """The kernel's bid of one row: each lane's sequential top 2 over its
    slots, then ``merge_levels(K)`` butterfly steps into lane 0 (higher v1
    wins, then the lower slot; the loser's v1 competes for v2).  ``p``,
    ``o`` map a column to its price / owner.  (j, bid, prev, found)."""
    zero = np.float32(0)
    K = ck.shape[0]
    levels = merge_levels(K)
    lanes = [[NEG, NEG, NEG, 1 << 31, 0, -1]           # v1 v2 a slot j own
             for _ in range(1 << levels)]
    for k in range(K):
        ln = lanes[k % 32]
        a = vk[k] + zero
        own, w = -1, NEG
        if a > _REAL_MIN:
            own = o[ck[k]]
            w = a - (p[ck[k]] + zero)
        if w > ln[0]:
            ln[:] = [w, ln[0], a, k, ck[k], own]
        elif w > ln[1]:
            ln[1] = w
    d = len(lanes) >> 1
    while d:
        nxt = []
        for me, ot in ((lanes[i], lanes[i ^ d]) for i in range(len(lanes))):
            if ot[0] > me[0] or (ot[0] == me[0] and ot[3] < me[3]):
                nxt.append([ot[0], ot[1] if ot[1] > me[0] else me[0],
                            *ot[2:]])
            else:
                nxt.append([me[0], ot[0] if ot[0] > me[1] else me[1],
                            *me[2:]])
        lanes, d = nxt, d >> 1
    v1, v2, a, _, j, own = lanes[0]
    found = bool(v1 > NEG)
    if not found:
        j, a, own = 0, NEG, o[0]
    if not v2 > _HALF:
        v2 = v1 - bigp
    return int(j), (a - v2) + eps, int(own), found


def gs_lookahead_mirror(cols, vals_masked, queue, qcount, prices, owner, eps,
                        bigp, max_bids, *, warps: int,
                        snapshot: str = "stalest", seed: int = 0):
    """The kernel's look-ahead protocol (``csrc/gs.cu`` part B) on the CPU,
    in numpy float32 scalars; same arguments and 5-tuple as
    ``gs_auction_plain``, plus the counters as ``counters()`` names them.

    Positions t are committed in ring order.  At a ring of one row, or
    with ``warps = 0``, the commit warp bids itself.  Otherwise bid warp t
    mod W has read the tables as they stood after c0 commits, c0 in [max(0,
    t - W), t]: the stalest the kernel allows (``snapshot="stalest"``) or
    drawn from ``seed`` (``"random"``).  Its result is committed unless a
    commit in [c0, t) stamped the hash of one of the row's real columns
    (STAMP_BITS bits, as the kernel's stamp table) or the row has no real
    slot; then the bid is redone on the current tables."""
    if snapshot not in ("stalest", "random"):
        raise ValueError(f"snapshot must be 'stalest' or 'random', got "
                         f"{snapshot!r}")
    cols, vals, queue, qcount, prices, owner, eps, bigp = _prepare(
        cols, vals_masked, queue, qcount, prices, owner, eps, bigp, "full")
    dev = cols.device
    c, v = cols.cpu().numpy(), vals.cpu().numpy()
    tables = [t.cpu() for t in (prices, owner, queue)]
    p, o, q = (t.numpy() for t in tables)
    rng = np.random.default_rng(seed)
    mask = (1 << STAMP_BITS) - 1
    stamps = np.full(mask + 1, -1, np.int64)
    log = []                       # commit c: (j, price, owner before it)
    cap = q.shape[0]
    tail, t = qcount, 0
    count = dict.fromkeys(COUNTERS, 0)
    ring = [0] * len(RING_BUCKETS)
    with np.errstate(over="ignore"):
        while t != tail and t < max_bids:
            length = tail - t
            ring[int(np.searchsorted([2, 4, 16, 64], length, "right"))] += 1
            u = q[t % cap]
            ck, vk = c[u], v[u]
            real = ck[vk + np.float32(0) > _REAL_MIN]
            res = None
            if warps > 0 and length > 1:
                lo = max(0, t - warps)
                c0 = lo if snapshot == "stalest" else int(
                    rng.integers(lo, t + 1))
                # the tables after c0 commits: undo commits t-1 .. c0 on
                # the row's columns (and column 0, a row with no real slot)
                sp = {j: p[j] for j in (*ck.tolist(), 0)}
                so = {j: o[j] for j in sp}
                for j, old_p, old_o in reversed(log[c0:]):
                    if j in sp:
                        sp[j], so[j] = old_p, old_o
                spec = _lane_bid(ck, vk, sp, so, eps, bigp)
                hit = not spec[3] or bool((stamps[real & mask] >= c0).any())
                count["redone" if hit else "speculative"] += 1
                res = None if hit else spec
            elif length == 1:
                count["single_row_ring"] += 1
            if res is None:
                res = _lane_bid(ck, vk, p, o, eps, bigp)
            j, bid, prev, _ = res
            log.append((j, p[j], o[j]))
            p[j], o[j] = bid, u
            stamps[j & mask] = t
            if prev >= 0:
                q[tail % cap] = prev
                tail += 1
            t += 1
    out = (*(x.to(dev) for x in tables), torch.tensor(t, device=dev),
           torch.tensor(tail - t, device=dev))
    return out, dict(bids=t, left=tail - t, **count,
                     ring=dict(zip(RING_BUCKETS, ring)))
