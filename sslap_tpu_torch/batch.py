"""Batched independent LAP instances (BASELINE config 3: tracking and
matching workloads solve many small LAPs per frame).  Counterpart of
``sslap_tpu/batch.py``.

Instances share one ELL shape [B, n, K] (``stack_problems`` pads K across
the batch; ``batch_from_dense`` builds one from a [B, n, m] stack).
``auction_solve_batched`` routes a batch:

  'device'  the eps-scaled Jacobi solve of every instance at once
            (``solve_ell_batched``): a batch axis in place of the
            reference's vmap, each round one launch of K1's batched entry
            and one of K2 over the flattened rows b * n + r and columns
            b * m + c;
  'hybrid'  the dense-chunk engine with native GS tails
            (``dense_batch.solve_batched_dense_hybrid``);
  'cpu'     the native Gauss-Seidel solve per instance;
  'auto'    'hybrid' on a CUDA device for a square batch that the dense
            engine takes and that brings no warm prices; else 'cpu'
            wherever the reference picks it (the native runtime is there,
            or the costs need host precision, and no mesh is given); else
            'device'.  The one departure from the reference's 'auto' is
            the dense hybrid, which beats 'cpu' on config 3 on the H100;
            'device' is the slowest arm there (PERF.md).

With ``mesh=`` the batch splits into equal blocks of instances over the
mesh's ``batch_axis``, each block solved by 'device' on its device (data
parallel, no collective: instances are independent, so the results equal
the call without a mesh); on a mesh that spans processes each process
solves its entries' blocks and the results are gathered; 'cpu' ignores
the mesh, as the reference does.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from sslap_tpu_torch import auction as _auction
from sslap_tpu_torch import ingest as _ingest
from sslap_tpu_torch.auction import DUMMY_OWNER, I32_MAX, neg_sentinel
from sslap_tpu_torch.ingest import ELLProblem
from sslap_tpu_torch.ops import bid_topk_batched, commit
from sslap_tpu_torch.utils import profiling as _prof


def stack_problems(probs: Sequence[ELLProblem]) -> ELLProblem:
    """Stack same-shape instances into a batched ELLProblem [B, n, K]."""
    n, m = probs[0].n, probs[0].m
    K = max(p.K for p in probs)
    if any((p.n, p.m) != (n, m) for p in probs):
        raise ValueError("all instances in a batch must share (n, m)")

    def pad(a, fill):
        a = np.asarray(a)
        padk = K - a.shape[1]
        if padk == 0:
            return a
        return np.pad(a, [(0, 0), (0, padk)], constant_values=fill)

    return ELLProblem(cols=np.stack([pad(p.cols, 0) for p in probs]),
                      vals=np.stack([pad(p.vals, 0) for p in probs]),
                      valid=np.stack([pad(p.valid, False) for p in probs]),
                      nvalid=np.stack([np.asarray(p.nvalid) for p in probs]),
                      n=n, m=m, int_exact=any(p.int_exact for p in probs))


def batch_from_dense(mats, **kw) -> ELLProblem:
    """[B, n, m] stack of dense matrices (negative / NaN = forbidden)."""
    mats = np.asarray(mats)
    if mats.ndim != 3:
        raise ValueError("expected [B, n, m] stack of dense matrices")
    return stack_problems([_ingest.from_dense(m, pad_to=None, **kw)
                           for m in mats])


def _instance(prob: ELLProblem, b: int) -> ELLProblem:
    return ELLProblem(cols=prob.cols[b], vals=prob.vals[b],
                      valid=prob.valid[b], nvalid=prob.nvalid[b], n=prob.n,
                      m=prob.m, int_exact=prob.int_exact)


class BatchedResult(NamedTuple):
    sigma: torch.Tensor          # [B, n] int32, local columns
    prices: torch.Tensor         # [B, m]
    rounds: np.ndarray           # [B]
    phases: np.ndarray           # [B]
    final_eps: np.ndarray        # [B], solver dtype
    unassigned: np.ndarray       # [B]: biddable rows left unassigned


def solve_ell_batched(cols, vals_t, valid, nvalid, p0, eps0, eps_min, theta,
                      max_iter, *, n_global: Optional[int] = None
                      ) -> BatchedResult:
    """``auction.solve_ell`` of every instance of a [B, n, K] batch (on
    ``p0``'s device), as the reference's vmap runs it
    (``auction.lane_phases``): each instance keeps its own bigp (its value
    range), eps, rounds and phases; a phase ends when its rows and dummies
    are placed.  A round is one K1 (batched entry) and one K2 launch over
    the rows of the instances in a phase; the rectangular dummy step and
    the violator scan are ``auction``'s, masked to the instances they
    concern.  ``solve_ell`` stays its own driver: it takes a given bigp,
    ``keep_assignment=False`` and the mixed eps tail, and launches K1's
    single-instance entry."""
    B, n, K = cols.shape
    m = p0.shape[1]
    N, M = B * n, B * m
    if max(N, M) >= I32_MAX:
        raise ValueError("batch too large for int32 ids: chunk it")
    n_dummy = m - (n if n_global is None else n_global)
    dtype = vals_t.dtype
    dev = p0.device
    neg = neg_sentinel(dtype)
    # per-instance bigp in the solver dtype (solve_ell's local reduction)
    vmax = torch.where(valid, vals_t, torch.full_like(vals_t, neg)) \
        .amax(dim=(1, 2))
    vmin = torch.where(valid, vals_t, torch.full_like(vals_t, -neg)) \
        .amin(dim=(1, 2))
    bigp_of = torch.clamp(vmax - vmin, min=0) + 1
    base = torch.arange(B, dtype=torch.int32, device=dev)
    # columns offset once to the flattened b * m + c
    cols_g = (cols + (base * m)[:, None, None]).reshape(N, K).contiguous()
    vals_f = vals_t.reshape(N, K)
    valid_f = valid.reshape(N, K)
    vals_m = _auction.mask_vals(vals_f, valid_f).contiguous()
    nvalid_f = nvalid.reshape(N).to(torch.int32).contiguous()
    prices = p0.to(dtype).reshape(M).clone()
    owner = torch.full((M,), -1, dtype=torch.int32, device=dev)
    sigma = torch.full((N,), -1, dtype=torch.int32, device=dev)
    keys = (torch.zeros(M, dtype=torch.int64, device=dev)
            if dev.type == "cuda" else None)
    rows = torch.arange(N, dtype=torch.int32, device=dev)
    inst = rows.long() // n
    biddable = nvalid_f > 0

    def left():
        c = ((sigma < 0) & biddable).view(B, n).sum(1)
        if n_dummy > 0:
            c = c + n_dummy - (owner == DUMMY_OWNER).view(B, m).sum(1)
        return c.cpu().numpy()

    def step(lanes, eps_of, eps):
        ids = torch.where((sigma < 0) & biddable & lanes[inst], rows, N)
        tgt, bid = bid_topk_batched(ids, cols_g, vals_m, nvalid_f, prices,
                                    sigma, owner, eps_of, bigp_of, n)
        commit(ids, tgt, bid, prices, owner, sigma, keys)
        if n_dummy > 0:
            _auction.dummy_grab_step(prices, owner, sigma, eps_of, n_dummy,
                                     lanes)

    def scan(lanes, eps_of, eps):
        _auction.unassign_violators(cols_g, vals_f, valid_f, prices, owner,
                                    sigma, eps_of, n_dummy, lanes)

    rounds, phases, eps = _auction.lane_phases(
        B, dev, _auction.numpy_dtype(dtype).type, eps0, eps_min, theta,
        int(max_iter), left, step, scan)
    sig = sigma.view(B, n)
    local = torch.where(sig >= 0, sig - (base * m)[:, None], sig)
    unassigned = ((sigma < 0) & biddable).view(B, n).sum(1).cpu().numpy()
    return BatchedResult(sigma=local, prices=prices.view(B, m),
                         rounds=rounds, phases=phases, final_eps=eps,
                         unassigned=unassigned)


def _auto_mode(prob: ELLProblem, needs_host_precision: bool, mesh, device,
               warm: bool) -> str:
    """'auto''s pick (see the module note): the reference's pick
    (``sslap_tpu/batch.py:127-135``), except that a square, cold batch
    that the dense engine takes runs the dense hybrid on a CUDA device
    (never a warm-started one, whose prices the engine cannot take)."""
    from sslap_tpu_torch import hybrid as _hybrid
    if mesh is not None:
        return "device"
    if torch.device(device).type == "cuda" and not warm:
        from sslap_tpu_torch import dense_batch as _db
        if _db.dense_hybrid_available(prob):
            return "hybrid"
    if needs_host_precision or _hybrid.native_available():
        return "cpu"
    return "device"


@_prof.entry()
def auction_solve_batched(
    prob: ELLProblem,
    problem: str = "min",
    eps_start=None,
    eps_min=None,
    theta: float = 5.0,
    max_iter: Optional[int] = None,
    warm_prices=None,
    mesh=None,
    batch_axis: str = "batch",
    chunk: Optional[int] = None,
    mode: str = "auto",
    device="cuda",
):
    """Solve a batch of independent instances; returns (sols [B, n] numpy
    int32, metas list), objectives computed exactly on the host.

    ``mode``: 'device', 'hybrid', 'cpu' or 'auto' (see the module note).
    ``chunk`` bounds the instances of one device pass: in 'device' mode
    (default 32 when B > 32 and B * n > 10**6, as in the reference; each
    chunk takes its own value range, transform and eps schedule, as there)
    and in 'hybrid' mode (default: as many dense blocks as fit 2 GiB).
    ``device`` is where the device rounds run ("cpu" runs the kernels'
    plain twins).  ``mesh`` (a ``parallel.Mesh``) shards the batch over
    its ``batch_axis`` in 'device' mode: B must divide evenly over it, and
    block i of B / size instances runs on the mesh's device i, in the
    process that owns it (no chunking)."""
    from sslap_tpu_torch.api import _objective_host
    cols, vals, valid, nvalid = prob.cols, prob.vals, prob.valid, prob.nvalid
    if cols.ndim != 3:
        raise ValueError("expected batched ELLProblem with leading axis")
    B = cols.shape[0]
    t0 = time.perf_counter()
    if mode not in ("auto", "device", "cpu", "hybrid"):
        raise ValueError(f"unknown mode {mode!r}")
    needs_host_precision = (np.dtype(vals.dtype) == np.float64
                            or prob.int_exact)
    if mode == "auto":
        mode = _auto_mode(prob, needs_host_precision, mesh, device,
                          warm_prices is not None)
    if mode == "hybrid":
        from sslap_tpu_torch import dense_batch as _db
        if not _db.dense_hybrid_available(prob):
            raise ValueError(
                "batched hybrid needs square float/int32 instances with "
                "n <= 16384 and the native toolchain; use mode='cpu'")
        if mesh is not None:
            raise ValueError("batched hybrid is single-device; drop mesh=")
        return _db.solve_batched_dense_hybrid(
            prob, problem=problem, eps_start=eps_start, eps_min=eps_min,
            theta=theta, max_iter=max_iter, chunk=chunk, device=device)
    if mode == "device" and needs_host_precision:
        raise ValueError(
            "float64 / exact-large-integer batched costs are solved on the "
            "host path: use mode='cpu' (or 'auto', without mesh=)")
    if mode == "cpu":
        from sslap_tpu_torch import hybrid as _hybrid
        sols = np.full((B, prob.n), -1, np.int32)
        metas = []
        for b in range(B):
            sub = _instance(prob, b)
            sol_b, _, meta_b = _hybrid.solve_hybrid(
                sub, problem=problem, eps_start=eps_start, eps_min=eps_min,
                theta=theta, max_iter=max_iter, mode="cpu",
                warm_prices=None if warm_prices is None else warm_prices[b])
            sols[b] = sol_b
            unassigned = meta_b["unassigned"] + int((sub.nvalid == 0).sum())
            metas.append(dict(meta_b, unassigned=unassigned,
                              soln_found=unassigned == 0,
                              obj=(_objective_host(sub, sol_b)
                                   if unassigned == 0 else None)))
        for mt in metas:
            mt["time"] = time.perf_counter() - t0
        return sols, metas
    if mesh is None:        # a mesh splits the batch itself: no chunks
        if chunk is None and B * prob.n > 1_000_000 and B > 32:
            chunk = 32
        # the flattened row and column ids of one pass must fit int32
        limit = (I32_MAX - 1) // max(prob.n, prob.m)
        if B > limit:
            chunk = min(chunk or limit, limit)
        if chunk is not None and chunk < B:
            sols_parts, metas = [], []
            for lo in range(0, B, chunk):
                hi = min(lo + chunk, B)
                sub = ELLProblem(cols=cols[lo:hi], vals=vals[lo:hi],
                                 valid=valid[lo:hi], nvalid=nvalid[lo:hi],
                                 n=prob.n, m=prob.m,
                                 int_exact=prob.int_exact)
                s_part, m_part = auction_solve_batched(
                    sub, problem=problem, eps_start=eps_start,
                    eps_min=eps_min, theta=theta, max_iter=max_iter,
                    warm_prices=None if warm_prices is None
                    else warm_prices[lo:hi], chunk=chunk, mode="device",
                    device=device)
                sols_parts.append(s_part)
                metas.extend(m_part)
            return np.concatenate(sols_parts, axis=0), metas
    if mesh is None:
        devices = [torch.device(device)]
        mine = [0]
    else:
        devices = mesh.devices
        mine = mesh.local_ranks()     # the mesh may span processes
        if B % mesh.shape[batch_axis] != 0:
            raise ValueError(
                f"batch size {B} must divide evenly over the "
                f"{mesh.shape[batch_axis]}-way '{batch_axis}' mesh axis")
    if any(d.type == "cuda" for d in devices) and \
            not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is "
                           "available")
    vmax_abs = float(np.abs(vals[valid]).max()) if valid.any() else 0.0
    # built without int_exact, as the reference builds it (batch.py:196)
    tr = _auction.make_transform(problem, prob.m, vals.dtype, vmax_abs)
    e0, e_min, theta_v = _auction.default_eps_schedule(
        vals.dtype, vmax_abs, prob.m, tr.scale, eps_min=eps_min,
        eps_start=eps_start, theta=theta)
    if max_iter is None:
        max_iter = _auction.default_max_iter(prob.n)
    p0 = (np.zeros((B, prob.m), vals.dtype) if warm_prices is None
          else np.asarray(warm_prices, vals.dtype))
    vals_t = tr.apply(vals)
    per = B // len(devices)
    parts = []
    for i in mine:                        # one block of instances a device
        blk = slice(i * per, (i + 1) * per)
        t = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a[blk])).to(devices[i])
        parts.append(solve_ell_batched(
            t(cols), t(vals_t), t(valid), t(nvalid.astype(np.int32)), t(p0),
            e0, e_min, theta_v, max_iter, n_global=prob.n))
    fields = [np.concatenate([r.sigma.cpu().numpy() for r in parts])] + [
        np.concatenate([getattr(r, f) for r in parts])
        for f in ("rounds", "phases", "final_eps", "unassigned")]
    if mesh is not None and mesh.spans_processes:
        # every process solved its blocks: gather them all (a collective)
        from sslap_tpu_torch.parallel.mesh import ProcessRows, fetch_global
        fields = [fetch_global(ProcessRows(f)) for f in fields]
    sols, rounds, phases, final_eps, left = fields
    t1 = time.perf_counter()
    metas = []
    for b in range(B):
        unassigned = int(left[b]) + int((nvalid[b] == 0).sum())
        found = unassigned == 0 and _auction.eps_reached(
            final_eps[b], e_min, vals.dtype)
        metas.append({
            "obj": (_objective_host(_instance(prob, b), sols[b])
                    if found else None),
            "its": int(rounds[b]),
            "phases": int(phases[b]),
            "soln_found": found,
            "final_eps": float(final_eps[b]) / tr.scale,
            "unassigned": unassigned,
            "time": t1 - t0,
        })
    return sols, metas
