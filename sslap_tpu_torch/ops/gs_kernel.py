"""K3: the serial FIFO Gauss-Seidel auction on the device.

Replaces ``sslap_tpu/ops/gs_kernel.py::_gs_kernel`` (Pallas, entered
through ``gs_auction_device``): pop a row from a ring of unassigned rows,
take the top 2 of ``vals - prices[cols]`` over its ELL slots (ties to the
lowest slot, which is the lowest column), bid ``a* - v2 + eps`` on the
best column, evict its owner to the tail of the ring; stop when the ring
is empty or after ``max_bids`` bids.  The bid semantics are those of the
native ``auction_gs`` (``sslap_tpu/native/sslap_native.cpp``), which is
its oracle.  The kernel is ``csrc/gs.cu``; ``gs_auction_plain`` is the
same function as a per-bid loop of torch ops.

One rule differs from the TPU kernel on purpose.  The TPU kernel treats a
slot as padding when ``vals <= -bigp``; for a min problem whose costs are
all >= 1 that holds for real entries too (bigp = range + 1 <= -vmin), and
the kernel then bids on padding.  Here padding is what the rest of the
port pads with, the neg sentinel: a slot is real when ``vals >
half_neg(float32)``, so the result is the native engine's on every input.

``gs_auction_device`` dispatches by device: a CPU tensor goes to the plain
twin, a CUDA tensor launches the kernel (or raises), nothing falls back.
"""

from __future__ import annotations

import numpy as np
import torch

from sslap_tpu_torch.auction import half_neg
from sslap_tpu_torch.ops import _build

NEG = np.float32(-3e38)            # w of a padding slot, as the TPU kernel
_HALF = NEG * np.float32(0.5)      # the TPU kernel's "has a second best"


def _prepare(cols, vals_masked, queue, qcount, prices, owner, eps, bigp):
    """The reference's casts (int32 cols/queue/owner, float32 vals/prices
    and scalars), the state copied (the op returns new tables), and the
    ring's preconditions checked."""
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
                     bigp, max_bids):
    """Plain torch twin of the kernel; same arguments and results.

    cols [n, K] int32; vals_masked [n, K] float32 transformed values,
    padding = the neg sentinel; queue [cap] ring whose first ``qcount``
    slots are the rows to run (cap >= n + 1; each row with >= 1 real
    entry); prices [m] float32; owner [m] int32 (-1 free).  Returns new
    (prices, owner, queue) and 0-d int64 tensors (bids done, rows left in
    the ring)."""
    cols, vals, queue, qcount, prices, owner, eps, bigp = _prepare(
        cols, vals_masked, queue, qcount, prices, owner, eps, bigp)
    dev = cols.device
    f32 = dict(dtype=torch.float32, device=dev)
    neg, half = torch.tensor(NEG, **f32), torch.tensor(_HALF, **f32)
    eps_t, bigp_t = torch.tensor(eps, **f32), torch.tensor(bigp, **f32)
    real_min = half_neg(torch.float32)
    cap = queue.shape[0]
    head, tail, bids = 0, qcount, 0
    while head != tail and bids < max_bids:
        u = int(queue[head])
        head = 0 if head + 1 == cap else head + 1
        ck = cols[u]
        vk = vals[u] + 0                  # the TPU kernel's one-hot reads
        w = torch.where(vk > real_min, vk - (prices[ck.long()] + 0), neg)
        v1, slot = w.max(0)               # first maximum: lowest slot
        found = v1 > neg
        rest = w.clone()
        rest[slot] = neg
        v2 = rest.max()
        v2 = torch.where(v2 > half, v2, v1 - bigp_t)
        astar = torch.where(found, vk[slot], neg)
        bid = (astar - v2) + eps_t
        jstar = torch.where(found, ck[slot], 0)
        j, prev = torch.stack([jstar, owner[jstar.long()]]).tolist()
        if prev >= 0:
            queue[tail] = prev
            tail = 0 if tail + 1 == cap else tail + 1
        prices[j] = bid
        owner[j] = u
        bids += 1
    left = tail - head if tail >= head else tail - head + cap
    return (prices, owner, queue, torch.tensor(bids, device=dev),
            torch.tensor(left, device=dev))


def gs_auction_device(cols, vals_masked, queue, qcount, prices, owner, eps,
                      bigp, max_bids):
    """K3: see ``gs_auction_plain`` for the contract.  CPU tensors run the
    twin; CUDA tensors launch ``csrc/gs.cu`` (one warp) on the current
    stream.  Runs to ring exhaustion or ``max_bids`` bids (infeasible
    inputs stop there with rows left instead of hanging)."""
    if cols.device.type == "cpu":
        return gs_auction_plain(cols, vals_masked, queue, qcount, prices,
                                owner, eps, bigp, max_bids)
    if cols.device.type != "cuda":
        raise RuntimeError(f"gs_auction_device: unsupported device "
                           f"{cols.device}")
    cols, vals, queue, qcount, prices, owner, eps, bigp = _prepare(
        cols, vals_masked, queue, qcount, prices, owner, eps, bigp)
    K = cols.shape[1]
    lib = _build.load()
    stats = torch.empty(2, dtype=torch.int64, device=cols.device)
    err = lib.sslap_gs_f32(
        cols.data_ptr(), vals.data_ptr(), K, queue.data_ptr(),
        queue.shape[0], qcount, prices.data_ptr(), owner.data_ptr(),
        float(eps), float(bigp), float(NEG), float(_HALF),
        half_neg(torch.float32), int(max_bids), stats.data_ptr(),
        torch.cuda.current_stream(cols.device).cuda_stream)
    _build.check(err, "gs_auction_device")
    gs_auction_device.launches += 1
    return prices, owner, queue, stats[0], stats[1]


gs_auction_device.launches = 0
