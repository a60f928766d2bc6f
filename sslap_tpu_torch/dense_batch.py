"""Dense-chunk batched hybrid engine (BASELINE config 3: many independent
small square instances).  Counterpart of ``sslap_tpu/dense_batch.py``.

Per chunk of instances, on the device: the ELL block is scattered once into
a dense [C, n, m] block of maximisation values (missing entries = the neg
sentinel); then eps phases of full-width Jacobi rounds, each round one
launch of the dense bid kernel DK (``ops.dense_bid``: per bidding row the
top-2 of A - p over the whole row) and one launch of K2 (``ops.commit``)
over the chunk's flattened columns b * m + c.  Each phase stops for an
instance once its active rows are <= ``trunc`` (only the final eps_min
phase must complete: the host finishes it), and each new phase starts with
the eps-CS violator scan (DK's row maxima, then a gather).  On the host:
one native Gauss-Seidel tail per instance at eps_min.

The reference vmaps the per-instance solve, so every instance keeps its
own loop control: its phase ends on its own active count and round count,
and it descends eps on its own.  Here the rounds of all running instances
share one DK and one K2 launch, and the loop control runs on the host per
instance (one small read back a round).  A worker thread runs the device
chunks while the calling thread runs the previous chunk's GS tails (the
native calls and torch's ops release the GIL); an exception in the worker
is raised in the caller.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from sslap_tpu_torch import auction as _auction
from sslap_tpu_torch import hybrid as _hybrid
from sslap_tpu_torch.auction import I32_MAX, neg_sentinel
from sslap_tpu_torch.ingest import ELLProblem
from sslap_tpu_torch.ops import commit, dense_bid
from sslap_tpu_torch.utils import profiling as _prof



def _dense_from_ell(cols, vals_t, valid, m: int):
    """[C, n, K] ELL -> [C, n, m] dense maximisation values; missing entries
    hold the neg sentinel.  A scatter-max: the duplicate padding entries
    carry the sentinel and never win."""
    C, n, K = cols.shape
    neg = neg_sentinel(vals_t.dtype)
    A = torch.full((C, n, m), neg, dtype=vals_t.dtype, device=vals_t.device)
    rows = torch.arange(C * n, device=cols.device).view(C, n, 1) * m
    upd = torch.where(valid, vals_t, torch.full_like(vals_t, neg))
    A.view(-1).scatter_reduce_(0, (rows + cols).view(-1), upd.view(-1),
                               "amax")
    return A


def _unassign_violators(A, nvalid, prices, owner_buf, sigma, eps_of, bigp,
                        lanes):
    """Phase-start warm start of the ``lanes`` [C] (bool tensor): free each
    of their rows whose column violates eps-CS at the lane's new eps (the
    mirror of the reference's ``_dense_unassign_violators``).  v1 is DK's
    row maximum; cur = A[r, sigma_r] - p[sigma_r].  ``owner_buf`` is owner
    with one extra slot that absorbs the writes of rows that stay."""
    C, n, m = A.shape
    N, M = C * n, C * m
    rows = torch.arange(N, dtype=torch.int32, device=A.device)
    ids = torch.where((sigma >= 0) & lanes.repeat_interleave(n), rows, N)
    _, _, v1 = dense_bid(ids, A, nvalid, prices, sigma, eps_of, bigp,
                         with_v1=True)
    live = ids < N
    sig = torch.where(live, sigma, 0).long()
    b = rows.long() // n
    cur = A.view(-1)[rows.long() * m + sig - b * m] - prices[sig]
    viol = live & (cur < v1 - eps_of[b])
    owner_buf[torch.where(viol, sig, M)] = -1
    sigma.masked_fill_(viol, -1)


def _solve_dense(A, nvalid, eps0, eps_min, theta, max_iter, bigp, trunc):
    """All eps phases of every lane of a dense [C, n, m] block with the
    reference's per-lane loop control (``auction.lane_phases``): a phase
    stops once the lane's active rows are <= ``trunc``; a round is one DK
    and one K2 launch over the bidding rows of the lanes in a phase.
    Returns (prices [C, m], sigma [C, n] with local columns, rounds [C],
    phases [C], eps [C] in the solver dtype)."""
    C, n, m = A.shape
    N, M = C * n, C * m
    dev = A.device
    dt = _auction.numpy_dtype(A.dtype).type
    bigp = dt(bigp)
    prices = torch.zeros(M, dtype=A.dtype, device=dev)
    owner_buf = torch.full((M + 1,), -1, dtype=torch.int32, device=dev)
    owner = owner_buf[:M]
    sigma = torch.full((N,), -1, dtype=torch.int32, device=dev)
    keys = (torch.zeros(M, dtype=torch.int64, device=dev)
            if dev.type == "cuda" else None)
    rows = torch.arange(N, dtype=torch.int32, device=dev)
    biddable = nvalid > 0

    def active():
        return ((sigma < 0) & biddable).view(C, n).sum(1).cpu().numpy()

    def step(lanes, eps_of, eps):
        ids = torch.where((sigma < 0) & biddable & lanes.repeat_interleave(n),
                          rows, N)
        tgt, bid = dense_bid(ids, A, nvalid, prices, sigma, eps_of, bigp)
        commit(ids, tgt, bid, prices, owner, sigma, keys)

    def scan(lanes, eps_of, eps):
        _unassign_violators(A, nvalid, prices, owner_buf, sigma, eps_of,
                            bigp, lanes)

    rounds, phases, eps = _auction.lane_phases(
        C, dev, dt, eps0, eps_min, theta, int(max_iter), active, step, scan,
        trunc=int(trunc))
    sig = sigma.view(C, n)
    base = (torch.arange(C, dtype=torch.int32, device=dev) * m)[:, None]
    local = torch.where(sig >= 0, sig - base, sig)
    return prices.view(C, m), local, rounds, phases, eps


def _solve_chunk(cols, vals_t, valid, nvalid, eps0, eps_min, theta,
                 max_iter, bigp, trunc):
    """The reference's vmapped ``_solve_chunk`` over [C, n, K] tensors
    (square): dense block, then ``_solve_dense``."""
    C, n, _ = cols.shape
    A = _dense_from_ell(cols, vals_t, valid, n)
    return _solve_dense(A, nvalid.reshape(C * n).to(torch.int32), eps0,
                        eps_min, theta, max_iter, bigp, trunc)


def dense_hybrid_available(prob: ELLProblem) -> bool:
    return (_hybrid.native_available()
            and prob.n == prob.m
            and prob.n <= 16384
            and not prob.int_exact
            and np.dtype(prob.vals.dtype) != np.float64)


def _host_csr(prob: ELLProblem, tr, B, n, m):
    """The whole batch's host CSR in one pass (batch-major), and the sorted
    (b n + r) m + c key table of the raw values for the exact objectives
    (None when some row's columns are not ascending)."""
    cols_all, vals_all, valid_np = prob.cols, prob.vals, prob.valid
    dtype = vals_all.dtype
    nvalid_all = np.asarray(prob.nvalid)
    counts = valid_np.sum(axis=2).astype(np.int64)          # [B, n]
    indptr_all = np.zeros((B, n + 1), np.int64)
    np.cumsum(counts, axis=1, out=indptr_all[:, 1:])
    indices_flat = cols_all[valid_np].astype(np.int32)
    data_flat = (vals_all[valid_np] *
                 np.asarray(tr.sign * tr.scale, dtype)).astype(dtype)
    inst_off = np.zeros(B + 1, np.int64)
    np.cumsum(counts.sum(axis=1), out=inst_off[1:])
    rows_flat = np.repeat(np.arange(B * n, dtype=np.int64), counts.ravel())
    obj_keys = rows_flat * m + indices_flat
    if obj_keys.size and not bool((np.diff(obj_keys) > 0).all()):
        obj_keys = None
    obj_vals = (vals_all[valid_np].astype(np.float64)
                if obj_keys is not None else None)
    return (nvalid_all, counts, indptr_all, indices_flat, data_flat,
            inst_off, obj_keys, obj_vals)


def _objectives(prob: ELLProblem, sols, obj_keys, obj_vals, B, n, m):
    """Exact per-instance objectives of the assigned pairs: a binary search
    in the sorted key table, or one [B, n, K] pass without it."""
    if obj_keys is not None:
        sig_flat = sols.ravel().astype(np.int64)
        rows_glob = np.arange(B * n, dtype=np.int64)
        matched = sig_flat >= 0
        q = rows_glob[matched] * m + sig_flat[matched]
        pos = np.searchsorted(obj_keys, q)
        pos_c = np.minimum(pos, max(obj_keys.size - 1, 0))
        ok = (pos < obj_keys.size) & (obj_keys[pos_c] == q)
        contrib = np.where(ok, obj_vals[pos_c], 0.0)
        return np.bincount(rows_glob[matched] // n, weights=contrib,
                           minlength=B)
    hit = (prob.cols == sols[:, :, None]) & prob.valid        # [B, n, K]
    return np.where(hit, prob.vals, 0).astype(np.float64).sum(axis=(1, 2))


def solve_batched_dense_hybrid(
    prob: ELLProblem,
    *,
    problem: str = "min",
    eps_start=None,
    eps_min=None,
    theta: float = 5.0,
    max_iter: Optional[int] = None,
    trunc: int = 128,
    chunk: Optional[int] = None,
    dense_budget_bytes: int = 2 << 30,
    return_prices: bool = False,
    device_cache: Optional[dict] = None,
    device="cuda",
):
    """Batched square instances via dense device chunks + native GS tails.

    Returns (sols [B, n] numpy int32, metas list) with the meta contract
    of ``batch.auction_solve_batched``; with ``return_prices`` also the
    final transformed-domain prices [B, m].  ``chunk`` instances share a
    device pass (default: as many dense [n, m] blocks as fit
    ``dense_budget_bytes``).  ``device_cache``: an AuctionSolver's dict;
    the value-range scalars and the host CSR are kept there, and the dense
    block too when the batch fits one chunk (one solver, one problem).
    ``device_time`` and ``host_gs_time`` are batch totals: the device
    passes (the worker thread's time per chunk, read back included) and
    the GS tails, which overlap."""
    if prob.cols.ndim != 3:
        raise ValueError("expected batched ELLProblem with leading axis")
    B, n, K = prob.cols.shape
    m = prob.m
    if n != m:
        raise ValueError("the dense batched engine is square-only")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is "
                           "available")
    t0 = time.perf_counter()
    with _prof.span("host_tables"):
        vals_np, valid_np = prob.vals, prob.valid
        dtype = vals_np.dtype
        skey = ("dense_scalars", B, n, K, str(dtype), prob.nnz, problem)
        if device_cache is not None and device_cache.get("dense_skey") == skey:
            vmax_abs, vmin_v, vmax_v = device_cache["dense_scalars"]
        else:
            if valid_np.any():
                vv = vals_np[valid_np]
                vmax_abs = float(np.abs(vv).max())
                vmin_v, vmax_v = float(vv.min()), float(vv.max())
                del vv
            else:
                vmax_abs = vmin_v = vmax_v = 0.0
            if device_cache is not None:
                device_cache.update(dense_skey=skey,
                                    dense_scalars=(vmax_abs, vmin_v, vmax_v))
        tr = _auction.make_transform(problem, m, dtype, vmax_abs,
                                     int_exact=prob.int_exact)
        e0, e_min, theta_v = _auction.default_eps_schedule(
            dtype, vmax_abs, m, tr.scale, eps_min=eps_min, eps_start=eps_start,
            theta=theta, int_exact=prob.int_exact)
        if max_iter is None:
            max_iter = _auction.default_max_iter(n)
        itemsize = np.dtype(dtype).itemsize
        if chunk is None:
            chunk = max(1, min(B, dense_budget_bytes // (n * m * itemsize)))
        # the flattened row and column ids of a chunk must fit int32
        chunk = max(1, min(chunk, (I32_MAX - 1) // max(n, m)))
        # bigp = transformed-value spread + 1, from the raw range (the
        # transform is linear)
        bigp = (abs(float(tr.sign * tr.scale)) * (vmax_v - vmin_v) + 1.0
                if valid_np.any() else 1.0)

        cache_key = (B, n, K, str(dtype), tr.sign, tr.scale, prob.nnz)
        if device_cache is not None and \
                device_cache.get("dense_key") == cache_key:
            csr = device_cache["dense_csr"]
        else:
            csr = _host_csr(prob, tr, B, n, m)
            if device_cache is not None:
                device_cache.update(dense_key=cache_key, dense_csr=csr)
        (nvalid_all, counts, indptr_all, indices_flat, data_flat, inst_off,
         obj_keys, obj_vals) = csr

    cache_chunks = device_cache is not None and chunk >= B
    scale = tr.sign * tr.scale

    def chunk_block(lo, hi):
        """The chunk's dense block and nvalid on the device (cached when
        the batch is one chunk)."""
        ckey = ("dense_dev", cache_key, lo, hi, str(dev))
        if cache_chunks and device_cache.get("dense_dev_key") == ckey:
            return device_cache["dense_dev"]
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
        A = _dense_from_ell(t(prob.cols[lo:hi]), t(vals_np[lo:hi]) * scale,
                            t(valid_np[lo:hi]), m)
        block = (A, t(nvalid_all[lo:hi].reshape(-1).astype(np.int32)))
        if cache_chunks:
            device_cache.update(dense_dev_key=ckey, dense_dev=block)
        return block

    results: "queue.Queue" = queue.Queue()
    stop = threading.Event()
    caller = _prof.current()

    def device_loop():
        try:
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                for lo in range(0, B, chunk):
                    if stop.is_set():
                        return
                    hi = min(lo + chunk, B)
                    # the chunk's share of meta["device_time"]
                    with _prof.span("chunk_pass", parent=caller) as cp:
                        with _prof.span("device_setup"):
                            A, nv_d = chunk_block(lo, hi)
                        out = _solve_dense(A, nv_d, e0, e_min, theta_v,
                                           max_iter, bigp, trunc)
                        del A, nv_d
                        prices_h = out[0].cpu().numpy()
                        sigma_h = out[1].cpu().numpy()
                    results.put((lo, hi, prices_h, sigma_h, *out[2:],
                                 cp.t1 - cp.t0))
        except BaseException as e:   # raised in the calling thread
            results.put(e)

    sols = np.full((B, n), -1, np.int32)
    prices_out = np.zeros((B, m), dtype) if return_prices else None
    metas = []
    dev_s = gs_s = 0.0
    e_min_h = np.asarray(e_min, dtype)
    bigp_h = np.asarray(bigp, dtype)
    worker = threading.Thread(target=device_loop, name="dense-batch",
                              daemon=True)
    worker.start()
    try:
        for _ in range(0, B, chunk):
            with _prof.span("queue_wait"):
                item = results.get()
            if isinstance(item, BaseException):
                raise item
            lo, hi, prices_h, sigma_h, rounds_h, phases_h, eps_h, d_s = item
            dev_s += d_s
            with _prof.span("gs_tail") as tail:
                for b in range(lo, hi):
                    i = b - lo
                    sl = slice(inst_off[b], inst_off[b + 1])
                    prices_b = prices_h[i].copy()
                    sigma_b = sigma_h[i].copy()
                    owner_b = np.full(m, -1, np.int32)
                    assigned = sigma_b >= 0
                    owner_b[sigma_b[assigned]] = \
                        np.nonzero(assigned)[0].astype(np.int32)
                    bids = _hybrid._gs(indptr_all[b], indices_flat[sl],
                                       data_flat[sl], prices_b, sigma_b,
                                       owner_b, e_min_h, bigp_h, 0,
                                       100 * n + 1_000_000)
                    unassigned = int(((sigma_b < 0) & (counts[b] > 0)).sum())
                    unassigned += int((nvalid_all[b] == 0).sum())
                    # a lane that stopped on max_iter above eps_min is not
                    # eps_min-optimal even when its GS tail completes it
                    eps_reached = bool(eps_h[i] <= e_min_h)
                    sols[b] = sigma_b
                    if return_prices:
                        prices_out[b] = prices_b
                    metas.append({
                        "obj": None,
                        "its": int(rounds_h[i]),
                        "phases": int(phases_h[i]),
                        "host_bids": max(int(bids), 0),
                        "soln_found": (unassigned == 0 and bids >= 0
                                       and eps_reached),
                        "final_eps": (float(e_min) if eps_reached
                                      else float(eps_h[i])) / tr.scale,
                        "unassigned": unassigned,
                        "mode": "dense-hybrid",
                    })
            gs_s += tail.t1 - tail.t0
    finally:
        stop.set()
        worker.join()

    with _prof.span("objective"):
        acc = _objectives(prob, sols, obj_keys, obj_vals, B, n, m)
        integral = np.issubdtype(prob.vals.dtype, np.integer) \
            or prob.int_exact
        for b, mt in enumerate(metas):
            if mt["soln_found"]:
                mt["obj"] = int(round(acc[b])) if integral \
                    else float(acc[b])
    total = time.perf_counter() - t0
    for mt in metas:
        mt["time"] = total
        mt["device_time"] = dev_s
        mt["host_gs_time"] = gs_s
    if return_prices:
        return sols, metas, prices_out
    return sols, metas
