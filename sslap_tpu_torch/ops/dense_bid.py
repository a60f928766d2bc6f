"""DK: the dense bid of the batched dense engine.

No TPU kernel is behind this op: it replaces
``sslap_tpu/dense_batch.py::_dense_bids``, which XLA compiles.  It gets a
hand kernel all the same because it is the only per-round op of the dense
engine that reads n x m elements, the whole device cost of a round.  The
kernel is ``csrc/dense_bid.cu`` (one warp per row, ``w = A - p`` never
stored; its note says what bounds it); ``dense_bid_plain`` is the same
function as torch ops, the mirror of ``_dense_bids``.

``dense_bid`` dispatches by device: a CPU tensor goes to the plain twin, a
CUDA tensor launches the kernel (or raises), and nothing falls back.
"""

from __future__ import annotations

import torch

from sslap_tpu_torch.auction import neg_sentinel
from sslap_tpu_torch.ops import _build
from sslap_tpu_torch.ops.bid import _scalar


def dense_bid_plain(ids, A, nvalid, prices, sigma, eps_of, bigp, *,
                    with_v1: bool = False):
    """Plain torch twin of the kernel; same arguments and results.

    ids [C] int32: rows b * n + r of the batch (pad = B * n); A [B, n, m]
    maximisation values, missing entries = the neg sentinel; nvalid [B * n];
    prices [B * m]; sigma [B * n] (a row bids when sigma < 0 and nvalid >
    0); eps_of [B] per instance; bigp a scalar.  Returns (tgt [C] int32:
    b * m + j for a row that bids, else B * m; bid [C], 0 at pads) and,
    with ``with_v1``, v1 [C] (the row's max of A - p, 0 at pads)."""
    B, n, m = A.shape
    dtype = A.dtype
    neg = neg_sentinel(dtype)
    bigp = _scalar(bigp, dtype)
    live = ids < B * n
    idx = torch.where(live, ids, 0).long()
    b = idx // n
    p = prices.view(B, m)[b]
    w = A.view(B * n, m)[idx] - p
    jstar = torch.argmax(w, dim=1, keepdim=True)          # first max
    v1 = w.gather(1, jstar)[:, 0]
    v2 = w.scatter(1, jstar, neg).amax(dim=1)
    nv = nvalid[idx]
    v2 = torch.where(nv >= 2, v2, v1 - bigp)
    a_star = v1 + p.gather(1, jstar)[:, 0]
    bid = a_star - v2 + eps_of[b]
    bidding = live & (sigma[idx] < 0) & (nv > 0)
    tgt = torch.where(bidding, b * m + jstar[:, 0], B * m).to(torch.int32)
    zero = torch.zeros_like(bid)
    out = (tgt, torch.where(live, bid, zero))
    return out + (torch.where(live, v1, zero),) if with_v1 else out


def dense_bid(ids, A, nvalid, prices, sigma, eps_of, bigp, *,
              with_v1: bool = False):
    """DK: see ``dense_bid_plain`` for the contract.  CPU tensors run the
    twin; CUDA tensors launch ``csrc/dense_bid.cu`` on the current
    stream."""
    if ids.device.type == "cpu":
        return dense_bid_plain(ids, A, nvalid, prices, sigma, eps_of, bigp,
                               with_v1=with_v1)
    if ids.device.type != "cuda":
        raise RuntimeError(f"dense_bid: unsupported device {ids.device}")
    dtype = A.dtype
    if dtype not in (torch.float32, torch.int32):
        raise TypeError(f"dense_bid: unsupported dtype {dtype}")
    B, n, m = A.shape
    C = ids.shape[0]
    if B * max(n, m) >= 2 ** 31 - 1:
        raise ValueError("dense_bid: B * max(n, m) must fit int32")
    for name, t, dt, shape in (
            ("ids", ids, torch.int32, (C,)), ("A", A, dtype, (B, n, m)),
            ("nvalid", nvalid, torch.int32, (B * n,)),
            ("prices", prices, dtype, (B * m,)),
            ("sigma", sigma, torch.int32, (B * n,)),
            ("eps_of", eps_of, dtype, (B,))):
        if t.device != ids.device or t.dtype != dt or \
                not t.is_contiguous() or t.shape != shape:
            raise ValueError(f"dense_bid: {name} must be a contiguous {dt} "
                             f"tensor of shape {shape} on {ids.device}")
    # 16-byte loads need 16-byte aligned rows
    vec = m % 4 == 0 and A.data_ptr() % 16 == 0 and \
        prices.data_ptr() % 16 == 0
    lib = _build.load()
    tgt = torch.empty(C, dtype=torch.int32, device=ids.device)
    bid = torch.empty(C, dtype=dtype, device=ids.device)
    v1 = torch.empty(C, dtype=dtype, device=ids.device) if with_v1 else None
    fn = (lib.sslap_dense_bid_f32 if dtype == torch.float32
          else lib.sslap_dense_bid_i32)
    err = fn(ids.data_ptr(), C, A.data_ptr(), nvalid.data_ptr(),
             prices.data_ptr(), sigma.data_ptr(), eps_of.data_ptr(),
             _scalar(bigp, dtype), neg_sentinel(dtype), n, m, B * n, B * m,
             int(vec), tgt.data_ptr(), bid.data_ptr(),
             None if v1 is None else v1.data_ptr(),
             torch.cuda.current_stream(ids.device).cuda_stream)
    _build.check(err, "dense_bid")
    dense_bid.launches += 1
    return (tgt, bid, v1) if with_v1 else (tgt, bid)


dense_bid.launches = 0
