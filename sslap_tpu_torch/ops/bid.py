"""K1: the bid stage of a compacted round, with the phase-start eps-CS
violator scan fused in.

Replaces ``sslap_tpu/ops/bid.py::_bid_kernel`` (Pallas, full-width ELL
rows: price gather by window-row load and one-hot lane select, top-2,
bid).  The TPU kernel could only serve the full-width Jacobi round
(``sslap_tpu/ops/__init__.py:26-37``); here the kernel takes the compacted
id list of ``compact_round``, so one kernel serves phase starts, the wide
loop and every ladder round.  The kernel is ``csrc/bid.cu``: a group of G
lanes of a warp shares each row (``row_group`` picks G from K); what
bounds it on the card, and what its design does about that, is noted
there.  ``bid_topk_plain`` is the same function as torch ops.

``bid_topk_batched`` is the batched entry of the same kernel (the
batched Jacobi solve, ``batch.py``): ids, columns and tables are a batch's,
flattened, and each row reads eps and bigp of its instance.

``bid_topk`` dispatches by device: a CPU tensor goes to the plain twin, a
CUDA tensor launches the kernel (or raises), and nothing falls back.
"""

from __future__ import annotations

import torch

from sslap_tpu_torch.auction import half_neg, neg_sentinel
from sslap_tpu_torch.ops import _build


LANE_SLOTS = 8       # slots a lane takes per step (csrc/round.cuh)


def _scalar(x, dtype: torch.dtype):
    """A Python scalar in ``dtype``'s kind; a tensor (per-row values of the
    plain twin) passes through."""
    if isinstance(x, torch.Tensor):
        return x
    return float(x) if dtype.is_floating_point else int(x)


def row_group(K: int, cols, vals_m):
    """The kernel's row group for rows of K slots: (G, V), G lanes of a
    warp on each row (the least power of two with 8 G >= K, at most 32:
    each lane takes up to 8 slots a step, so a warp bids on 32 / G rows at
    once) and V slots a load (4: one 16-byte load, when K % 4 == 0 and both
    row tables are 16-byte aligned; else 1)."""
    lanes = 1
    while lanes < 32 and LANE_SLOTS * lanes < K:
        lanes *= 2
    vec = 4 if K % 4 == 0 and cols.data_ptr() % 16 == 0 and \
        vals_m.data_ptr() % 16 == 0 else 1
    return lanes, vec


def bid_topk_plain(ids, cols, vals_m, nvalid, prices, sigma, owner, eps,
                   bigp, *, phase_start: bool = False):
    """Plain torch twin of the kernel; same arguments and results.

    ids [C] int32 (pad = n); cols [n, K] int32; vals_m [n, K] (padding =
    neg sentinel); nvalid [n]; prices [m]; sigma [n]; owner [m]; eps and
    bigp scalars, or [C] tensors of per-row values (pad slots ignored).  With
    ``phase_start`` violators are unassigned IN PLACE in ``sigma`` and
    ``owner``.  Returns (tgt [C] int32, m = no bid; bid [C], 0 at pads)."""
    n = sigma.shape[0]
    m = prices.shape[0]
    dtype = vals_m.dtype
    neg = neg_sentinel(dtype)
    eps, bigp = _scalar(eps, dtype), _scalar(bigp, dtype)
    live = ids < n
    idx = torch.where(live, ids, 0).long()
    colsC = cols[idx]
    valsC = vals_m[idx]
    nvC = torch.where(live, nvalid[idx], 0)
    w = valsC - prices[colsC.long()]
    slot = torch.argmax(w, dim=1, keepdim=True)          # first max
    v1 = w.gather(1, slot)[:, 0]
    v2 = w.scatter(1, slot, neg).amax(dim=1)
    v2 = torch.where(nvC >= 2, v2, v1 - bigp)
    # + 0: the reference's one-hot sum turns a -0.0 entry into +0.0
    a_star = valsC.gather(1, slot)[:, 0] + 0
    jstar = colsC.gather(1, slot)[:, 0]
    bid = a_star - v2 + eps
    if phase_start:
        sigC = torch.where(live, sigma[idx], -1)
        real = w > half_neg(dtype)
        cur = torch.where((colsC == sigC[:, None]) & real, w,
                          torch.zeros_like(w)).sum(dim=1)
        viol = (sigC >= 0) & (cur < v1 - eps)
        # In place: free the violators' columns and rows (a matching, so
        # the writes are disjoint); they bid in this same round.
        owner[sigC[viol].long()] = -1
        sigma[ids[viol].long()] = -1
        bidding = live & (nvC > 0) & ((sigC < 0) | viol)
    else:
        bidding = live & (nvC > 0)
    tgt = torch.where(bidding, jstar, m).to(torch.int32)
    return tgt, torch.where(live, bid, torch.zeros_like(bid))


def bid_topk(ids, cols, vals_m, nvalid, prices, sigma, owner, eps, bigp,
             *, phase_start: bool = False):
    """K1: see ``bid_topk_plain`` for the contract.  CPU tensors run the
    twin; CUDA tensors launch ``csrc/bid.cu`` on the current stream."""
    if ids.device.type == "cpu":
        return bid_topk_plain(ids, cols, vals_m, nvalid, prices, sigma,
                              owner, eps, bigp, phase_start=phase_start)
    if ids.device.type != "cuda":
        raise RuntimeError(f"bid_topk: unsupported device {ids.device}")
    dtype = vals_m.dtype
    if dtype not in (torch.float32, torch.int32):
        raise TypeError(f"bid_topk: unsupported dtype {dtype}")
    n, K = cols.shape
    m = prices.shape[0]
    C = ids.shape[0]
    for name, t, dt in (("ids", ids, torch.int32), ("cols", cols, torch.int32),
                        ("nvalid", nvalid, torch.int32),
                        ("sigma", sigma, torch.int32),
                        ("owner", owner, torch.int32),
                        ("vals_m", vals_m, dtype), ("prices", prices, dtype)):
        if t.device != ids.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"bid_topk: {name} must be a contiguous {dt} "
                             f"tensor on {ids.device}")
    if vals_m.shape != (n, K) or nvalid.shape != (n,) or \
            sigma.shape != (n,) or owner.shape != (m,):
        raise ValueError("bid_topk: inconsistent shapes")
    G, V = row_group(K, cols, vals_m)
    lib = _build.load()
    tgt = torch.empty(C, dtype=torch.int32, device=ids.device)
    bid = torch.empty(C, dtype=dtype, device=ids.device)
    fn = lib.sslap_bid_f32 if dtype == torch.float32 else lib.sslap_bid_i32
    err = fn(ids.data_ptr(), C, cols.data_ptr(), vals_m.data_ptr(),
             nvalid.data_ptr(), prices.data_ptr(), sigma.data_ptr(),
             owner.data_ptr(), n, m, K, _scalar(eps, dtype),
             _scalar(bigp, dtype), neg_sentinel(dtype), half_neg(dtype),
             int(phase_start), G, V, tgt.data_ptr(), bid.data_ptr(),
             torch.cuda.current_stream(ids.device).cuda_stream)
    _build.check(err, "bid_topk")
    bid_topk.launches += 1
    return tgt, bid


bid_topk.launches = 0


def bid_topk_batched_plain(ids, cols, vals_m, nvalid, prices, sigma, owner,
                           eps_of, bigp_of, rows_per: int, *,
                           phase_start: bool = False):
    """Plain twin of the batched entry: ``bid_topk_plain`` over a batch
    flattened to N = B * rows_per rows and M = B * m columns (cols hold
    b * m + c), with eps_of [B] and bigp_of [B] read per row at
    ids // rows_per (pad ids read instance 0)."""
    b = torch.where(ids < sigma.shape[0], ids, 0).long() // rows_per
    return bid_topk_plain(ids, cols, vals_m, nvalid, prices, sigma, owner,
                          eps_of[b], bigp_of[b], phase_start=phase_start)


def bid_topk_batched(ids, cols, vals_m, nvalid, prices, sigma, owner,
                     eps_of, bigp_of, rows_per: int, *,
                     phase_start: bool = False):
    """K1's batched entry: see ``bid_topk_batched_plain``.  CPU tensors run
    the twin; CUDA tensors launch ``csrc/bid.cu``'s batched entry."""
    if ids.device.type == "cpu":
        return bid_topk_batched_plain(ids, cols, vals_m, nvalid, prices,
                                      sigma, owner, eps_of, bigp_of,
                                      rows_per, phase_start=phase_start)
    if ids.device.type != "cuda":
        raise RuntimeError(f"bid_topk_batched: unsupported device "
                           f"{ids.device}")
    dtype = vals_m.dtype
    if dtype not in (torch.float32, torch.int32):
        raise TypeError(f"bid_topk_batched: unsupported dtype {dtype}")
    n, K = cols.shape
    m = prices.shape[0]
    C = ids.shape[0]
    B = eps_of.shape[0]
    for name, t, dt in (("ids", ids, torch.int32), ("cols", cols, torch.int32),
                        ("nvalid", nvalid, torch.int32),
                        ("sigma", sigma, torch.int32),
                        ("owner", owner, torch.int32),
                        ("vals_m", vals_m, dtype), ("prices", prices, dtype),
                        ("eps_of", eps_of, dtype),
                        ("bigp_of", bigp_of, dtype)):
        if t.device != ids.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"bid_topk_batched: {name} must be a contiguous "
                             f"{dt} tensor on {ids.device}")
    if vals_m.shape != (n, K) or nvalid.shape != (n,) or \
            sigma.shape != (n,) or owner.shape != (m,) or \
            bigp_of.shape != (B,) or n != B * rows_per or m % B:
        raise ValueError("bid_topk_batched: inconsistent shapes")
    G, V = row_group(K, cols, vals_m)
    lib = _build.load()
    tgt = torch.empty(C, dtype=torch.int32, device=ids.device)
    bid = torch.empty(C, dtype=dtype, device=ids.device)
    fn = (lib.sslap_bid_batched_f32 if dtype == torch.float32
          else lib.sslap_bid_batched_i32)
    err = fn(ids.data_ptr(), C, cols.data_ptr(), vals_m.data_ptr(),
             nvalid.data_ptr(), prices.data_ptr(), sigma.data_ptr(),
             owner.data_ptr(), n, m, K, eps_of.data_ptr(), bigp_of.data_ptr(),
             rows_per, neg_sentinel(dtype), half_neg(dtype), int(phase_start),
             G, V, tgt.data_ptr(), bid.data_ptr(),
             torch.cuda.current_stream(ids.device).cuda_stream)
    _build.check(err, "bid_topk_batched")
    bid_topk_batched.launches += 1
    return tgt, bid


bid_topk_batched.launches = 0
