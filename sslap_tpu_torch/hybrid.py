"""Hybrid device+host auction solve: the square fast path, the
rectangular per-phase path and mode='cpu'.  Counterpart of
``sslap_tpu/hybrid.py``.

Square flow (the headline path):

  device: every eps phase through the tiered compacted solve
      (compact.solve_tiered: on CUDA one ladder-kernel launch per phase),
      each phase truncated once <= ``trunc`` rows are active -- correct
      because only the final phase must complete at eps_min; earlier
      phases precondition prices;
  one device->host copy of prices and sigma (owner is derived);
  host: ONE native C++ Gauss-Seidel pass at eps_min (the forward-reverse
      engine ``auction_gs_fr`` by default) finishes the serial eviction
      chains, with the device's bid semantics.

Rectangular (n < m) problems keep the per-phase device/host split with
implicit dummy rows: per eps phase, full-width Jacobi rounds with the dummy
step on the device (``_device_phase``: K1/K2 and a torch sort) until <=
``threshold`` rows and dummies are unplaced, then the native forward GS
with its dummy price heap finishes the phase on the host.

``engine='candidates'`` swaps the square device pass for the
candidate-list engine (``candidate.solve_candidates``: shortlist rounds
above 4096 active rows, K1 + K2 compact rounds below, every phase
truncated at ``trunc``) over the same cached rows, with the reference's
default ladder and no mixed tail; the host tail is the same.

``mode='cpu'`` skips the device: a native Gauss-Seidel eps-scaled solve,
the sslap-class CPU reference.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from sslap_tpu_torch import _native
from sslap_tpu_torch import auction as _auction
from sslap_tpu_torch import candidate as _candidate
from sslap_tpu_torch import compact as _compact
from sslap_tpu_torch.ingest import ELLProblem
from sslap_tpu_torch.utils import profiling as _prof

if _native.auction_gs is not None:
    _gs, _unassign = _native.auction_gs, _native.unassign_violators_native
else:  # no toolchain: pure-numpy engine, same bid semantics, slower
    _gs = _native.gs_host.auction_gs_numpy
    _unassign = _native.gs_host.unassign_violators_numpy


def native_available() -> bool:
    """True when the native (C++) host engine is loaded."""
    return _native.native_available()


def ell_to_csr_transformed(prob: ELLProblem, sign: int, scale: int
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host CSR of transformed (maximization) values, with the device's
    transform arithmetic (same dtype)."""
    if _native.ell_to_csr_native is not None:
        out = _native.ell_to_csr_native(prob.cols, prob.vals, prob.valid,
                                        prob.vals.dtype.type(sign * scale),
                                        int(prob.valid.sum()))
        if out is not None:
            return out
    counts = prob.valid.sum(axis=1).astype(np.int64)
    indptr = np.zeros(prob.n + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = prob.cols[prob.valid].astype(np.int32)
    data = (prob.vals[prob.valid] *
            np.asarray(sign * scale, prob.vals.dtype)).astype(prob.vals.dtype)
    return indptr, indices, data


def _csr_to_csc(indptr, indices, data, n, m):
    """Column-major twin of the host CSR (for the FR engine's reverse
    passes): the native stable counting sort, else numpy's stable argsort,
    which the native output equals bit for bit.  One nnz extent,
    ``indptr[-1]``, bounds the argsort, the gathers AND the column counts,
    so an over-allocated ``indices`` buffer cannot leak entries past nnz
    into the counts."""
    if _native.csr_to_csc_native is not None:
        out = _native.csr_to_csc_native(indptr, indices, data, n, m)
        if out is not None:
            return out
    nnz = int(indptr[-1])
    ind = np.asarray(indices)[:nnz]
    rows_flat = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    order = np.argsort(ind, kind="stable")
    cindices = rows_flat[order].astype(np.int32)
    cvals = np.ascontiguousarray(np.asarray(data)[:nnz][order])
    counts = np.bincount(ind, minlength=m)
    cindptr = np.zeros(m + 1, np.int64)
    np.cumsum(counts, out=cindptr[1:])
    return cindptr, cindices, cvals


def _run_gs(indptr, indices, data, prices, sigma, owner, eps, bigp,
            n_dummy, budget, csc=None, profits=None):
    """One host finisher pass: the forward-reverse engine when a CSC is
    supplied (square only), else the forward GS.  Mutates prices, sigma,
    owner (and profits) in place."""
    if csc is not None and n_dummy == 0:
        cindptr, cindices, cvals = csc
        return _native.auction_gs_fr(indptr, indices, data, cindptr,
                                     cindices, cvals, prices, profits,
                                     sigma, owner, eps, bigp, budget)
    return _gs(indptr, indices, data, prices, sigma, owner, eps, bigp,
               n_dummy, budget)


def _wide_layout_ok(cols: np.ndarray, valid: np.ndarray, m: int) -> bool:
    """The reference's wide-layout skew guard (``widebid.py:133``): with
    entries grouped into 128-column windows (invalid slots spread over
    windows q % NB, lane 0), refuse when NB * E > 3 nK + 128 NB, E the
    fullest window.  The port has no window layout; mirroring the guard
    keeps its wide loop on exactly the instances the reference's runs."""
    n, K = cols.shape
    nK = n * K
    NB = -(-m // 128)
    eff = np.clip(cols.reshape(-1).astype(np.int64), 0, m - 1)
    inval = ~valid.reshape(-1)
    q = np.flatnonzero(inval)
    eff[inval] = np.minimum((q % NB) * 128, m - 1)
    E = max(int(np.bincount(eff >> 7, minlength=NB).max()), 1) if nK else 1
    return not NB * E > 3 * nK + NB * 128


def _device_phase(cols, vals_m, nvalid, prices, owner, sigma, eps, bigp,
                  threshold, max_rounds, n_dummy, keys=None):
    """Jacobi rounds (plus the dummy step) at fixed eps until <=
    ``threshold`` rows and dummies are unplaced, everything is placed, or
    ``max_rounds`` rounds are spent.  ``prices``, ``owner`` and ``sigma``
    are updated IN PLACE.  Returns (prices, owner, sigma, rounds,
    active)."""
    dt = _auction.numpy_dtype(vals_m.dtype).type
    eps, bigp = dt(eps), dt(bigp)

    def active():
        a = _auction.count_unassigned_rows(sigma, nvalid)
        if n_dummy > 0:
            a = a + _auction.count_unassigned_dummies(owner, n_dummy)
        return int(a)

    rounds = 0
    left = active()
    while left > threshold and rounds < max_rounds:
        _auction.jacobi_round(cols, vals_m, nvalid, prices, owner, sigma, eps,
                              bigp, keys)
        if n_dummy > 0:
            _auction.dummy_grab_step(prices, owner, sigma, eps, n_dummy)
        rounds += 1
        left = active()
    return prices, owner, sigma, rounds, left


def _device_ell(prob: ELLProblem, tr, dev, device_cache):
    """cols, vals_m (transformed, padding = neg sentinel) and nvalid on
    ``dev``, cached per solver: the cache belongs to ONE AuctionSolver
    bound to one problem, and the shape/transform fields of the key catch
    accidental reuse across problems."""
    dtype = prob.vals.dtype
    key = (tr.sign, tr.scale, str(dtype), prob.n, prob.m, prob.K, prob.nnz,
           str(dev))
    if device_cache is not None and device_cache.get("key") == key:
        return key, device_cache["ell"]
    neg = _auction.neg_sentinel_np(dtype)
    vals_m = np.where(prob.valid, tr.apply(prob.vals), neg)
    ell = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (prob.cols, vals_m, prob.nvalid.astype(np.int32)))
    if device_cache is not None:
        device_cache.update(key=key, ell=ell)
    return key, ell


def _finish_square_fast_path(res, tier_rounds, indptr, indices, data,
                             owner, e_min, bigp, tr, n, mode, t0, t_dev,
                             csc=None):
    """Shared tail of the square hybrid, after the device pass (``t_dev``
    seconds from ``t0``): read back, run the native finisher at eps_min,
    build the meta dict."""
    with _prof.span("readback") as rb:
        # The native finisher mutates prices/sigma in place: writable,
        # contiguous host copies, never views of device-shared buffers.
        prices = np.array(res.prices.cpu().numpy(), order="C", copy=True)
        sigma = np.array(res.sigma.cpu().numpy(), order="C", copy=True)
    owner[:] = -1
    assigned = sigma >= 0
    owner[sigma[assigned]] = np.nonzero(assigned)[0].astype(np.int32)
    with _prof.span("gs_tail") as gs:
        bids = _run_gs(indptr, indices, data, prices, sigma, owner, e_min,
                       bigp, 0, 100 * n + 10_000_000, csc=csc,
                       profits=(np.zeros(n, prices.dtype)
                                if csc is not None else None))
    unassigned = int(((sigma < 0) & (np.diff(indptr) > 0)).sum())
    eps_reached = _auction.eps_reached(res.final_eps, e_min, data.dtype)
    meta = {
        "its": int(res.rounds),
        "host_bids": max(int(bids), 0),
        "phases": int(res.phases),
        "final_eps": (float(e_min) if eps_reached
                      else float(res.final_eps)) / tr.scale,
        "unassigned": unassigned,
        "soln_found": unassigned == 0 and bids >= 0 and eps_reached,
        "time": time.perf_counter() - t0,
        "device_time": t_dev,
        "readback_time": rb.t1 - rb.t0,
        "host_gs_time": gs.t1 - gs.t0,
        "tier_rounds": list(tier_rounds),
        "mode": mode,
    }
    return sigma, prices, meta


def _ladder_setup(prob: ELLProblem, cache_key, device_cache, trunc: int,
                  fine_ladder, wide_rounds, theta_tail, e0):
    """The ladder's tiers, its wide-round flag (the skew guard's verdict,
    cached per solver) and theta_tail in the dtype of the eps start, as
    the reference hands it to its device program."""
    n = prob.n
    tiers = _compact.default_tiers(
        n, fine=True if fine_ladder is None else bool(fine_ladder),
        floor=trunc)
    if wide_rounds is None:
        wide_rounds = n >= 400_000
    wide = False
    if wide_rounds:
        if device_cache is not None and \
                device_cache.get("wide_key") == cache_key:
            wide = device_cache["wide"]
        else:
            wide = _wide_layout_ok(prob.cols, prob.valid, prob.m)
            if device_cache is not None:
                device_cache.update(wide_key=cache_key, wide=wide)
    tt = np.asarray(theta_tail,
                    np.int32 if isinstance(e0, int) else np.float32)
    return tiers, wide, tt


def solve_hybrid(
    prob: ELLProblem,
    *,
    problem: str = "min",
    eps_start=None,
    eps_min=None,
    theta: Optional[float] = None,
    theta_tail: Optional[float] = None,
    tail_phases: int = 2,
    max_iter: Optional[int] = None,
    threshold: int = 4096,
    trunc: int = 256,
    mode: str = "hybrid",            # 'hybrid' | 'cpu'
    warm_prices=None,
    n_real: Optional[int] = None,
    keep_assignment: bool = True,
    engine: str = "compact",
    device_cache: Optional[dict] = None,
    wide_rounds: Optional[bool] = None,
    fine_ladder: Optional[bool] = None,
    warm_fr: int = 0,
    gs_engine: str = "auto",         # 'auto' | 'forward' | 'fr'
    device="cuda",
):
    """eps-scaled solve with device bulk + host tail (``mode='hybrid'``) or
    pure host (``mode='cpu'``).  ``trunc`` is the square fast path's
    per-phase truncation point, ``threshold`` the rectangular path's (the
    device leaves <= that many unplaced rows and dummies per phase to the
    host GS).  ``n_real`` (default n) counts the real rows; the other
    m - n_real are implicit dummies.  ``device`` is where the device
    rounds run.

    Returns (sigma [n] numpy int32, prices numpy, meta dict)."""
    n, m = prob.n, prob.m
    n_real = n if n_real is None else n_real
    n_dummy = m - n_real
    square_hybrid = mode == "hybrid" and n_dummy == 0
    # per-mode defaults: the device schedule (and its mixed tail) on the
    # square hybrid, the sslap-class schedule everywhere else
    if theta is None:
        theta = (_auction.device_theta_default(n) if square_hybrid
                 else _auction.HOST_THETA)
    if theta_tail is None:
        theta_tail = 3.0 if square_hybrid and float(theta) > 5 else 0.0
    with _prof.span("host_tables"):
        vals_np, valid_np = prob.vals, prob.valid
        dtype = vals_np.dtype
        vmax_abs = float(np.abs(vals_np[valid_np]).max()) \
            if valid_np.any() else 0.0
        tr = _auction.make_transform(problem, m, dtype, vmax_abs,
                                     int_exact=prob.int_exact)
        e0, e_min, theta_v = _auction.default_eps_schedule(
            dtype, vmax_abs, m, tr.scale, eps_min=eps_min,
            eps_start=eps_start, theta=theta, int_exact=prob.int_exact)
        if max_iter is None:
            max_iter = _auction.default_max_iter(n)

        csr_key = ("csr", tr.sign, tr.scale)
        if device_cache is not None and \
                device_cache.get("csr_key") == csr_key:
            indptr, indices, data = device_cache["csr"]
        else:
            indptr, indices, data = ell_to_csr_transformed(prob, tr.sign,
                                                           tr.scale)
            if device_cache is not None:
                device_cache.update(csr_key=csr_key,
                                    csr=(indptr, indices, data))
        if gs_engine == "auto":   # FR tail on the square hybrid only
            gs_engine = ("fr" if square_hybrid and n == m
                         and native_available() else "forward")
        csc = None
        if gs_engine == "fr" and n == m and native_available():
            if device_cache is not None and \
                    device_cache.get("csc_key") == csr_key:
                csc = device_cache["csc"]
            else:
                with _prof.span("csc"):
                    csc = _csr_to_csc(indptr, indices, data, n, m)
                if device_cache is not None:
                    device_cache.update(csc_key=csr_key, csc=csc)
        if valid_np.any():
            bigp = (data.max() - data.min()) + \
                (1 if np.issubdtype(dtype, np.integer) else 1.0)
        else:
            bigp = 1
        is_int = np.issubdtype(dtype, np.integer) or prob.int_exact
        prices = np.zeros(m, dtype) if warm_prices is None else \
            np.array(warm_prices, dtype)

    if warm_prices is not None and warm_fr > 0:
        with _prof.span("fr_tighten"):
            _auction.fr_tighten(indptr, indices, data, prices, iters=warm_fr)
    sigma = np.full(n, -1, np.int32)
    owner = np.full(m, -1, np.int32)

    use_device = mode == "hybrid"
    if use_device:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but no CUDA device "
                               "is available")
    if square_hybrid:
        trunc_static = min(int(trunc), max(n // 8, 1))
        # meta["device_time"] is this span: from the first upload to the
        # pass's end on the device
        with _prof.span("device_pass") as dp:
            with _prof.span("device_setup"):
                cache_key, (cols_d, vals_d, nvalid_d) = _device_ell(
                    prob, tr, dev, device_cache)
                p0 = torch.from_numpy(prices).to(dev)
                if engine != "candidates":
                    tiers, wide, tt = _ladder_setup(
                        prob, cache_key, device_cache, trunc_static,
                        fine_ladder, wide_rounds, theta_tail, e0)
            if engine == "candidates":
                # the reference's non-compact square path: default_tiers(n),
                # no mixed tail, the host bigp; the cached rows are already
                # masked, as the engine masks its values
                res, st = _candidate.solve_candidates(
                    cols_d, vals_d, nvalid_d, p0, e0, e_min, theta_v,
                    max_iter, bigp=bigp, trunc=trunc_static)
            else:
                res, st = _compact.solve_tiered(
                    cols_d, vals_d, nvalid_d, p0, e0, e_min, theta_v,
                    max_iter, bigp=bigp, tiers=tiers, trunc=trunc_static,
                    theta_tail=tt[()], tail_phases=tail_phases, wide=wide)
            if res.prices.device.type == "cuda":
                torch.cuda.synchronize(res.prices.device)
        return _finish_square_fast_path(
            res, st.tier_rounds, indptr, indices, data, owner, e_min, bigp,
            tr, n, mode, dp.t0, dp.t1 - dp.t0, csc=csc)

    # Per-phase loop: mode='cpu', or the rectangular hybrid, whose device
    # rounds run each phase down to ``threshold`` before the host GS.
    if use_device:
        _, (cols_d, vals_d, nvalid_d) = _device_ell(prob, tr, dev,
                                                    device_cache)
        d_prices = torch.from_numpy(prices).to(dev)
        keys = (torch.zeros(m, dtype=torch.int64, device=dev)
                if dev.type == "cuda" else None)
    profits = np.zeros(n, dtype) if csc is not None else None
    eps = max(e0, e_min)
    total_rounds = 0
    total_bids = 0
    phases = 0
    t0 = time.perf_counter()
    # per-phase bid budget, scaled by every bidder (rows and dummies)
    host_budget = 50 * (n + n_dummy) + 100_000
    first_phase = True
    while True:
        if not first_phase and keep_assignment:
            _unassign(indptr, indices, data, prices, sigma, owner, eps,
                      n_dummy)
        elif not first_phase:
            sigma[:] = -1
            owner[:] = -1
        first_phase = False
        if use_device:
            d_sigma = torch.from_numpy(sigma).to(dev)
            d_owner = torch.from_numpy(owner).to(dev)
            d_prices, d_owner, d_sigma, rounds, _ = _device_phase(
                cols_d, vals_d, nvalid_d, d_prices, d_owner, d_sigma, eps,
                bigp, threshold, max(max_iter - total_rounds, 0), n_dummy,
                keys)
            total_rounds += rounds
            # writable host copies for the native GS (it works in place)
            prices = np.array(d_prices.cpu().numpy(), order="C", copy=True)
            sigma = np.array(d_sigma.cpu().numpy(), order="C", copy=True)
            owner = np.array(d_owner.cpu().numpy(), order="C", copy=True)
        bids = _run_gs(indptr, indices, data, prices, sigma, owner, eps,
                       bigp, n_dummy, host_budget, csc=csc, profits=profits)
        if bids < 0:
            break  # bid budget exhausted: likely infeasible
        total_bids += bids
        phases += 1
        if eps <= e_min or total_rounds >= max_iter:
            break
        if use_device:
            d_prices = torch.from_numpy(prices).to(dev)
        eps = max(eps // theta_v, e_min) if is_int else \
            max(eps / theta_v, e_min)

    unassigned = int(((sigma < 0) & (np.diff(indptr) > 0)).sum())
    if n_dummy > 0:
        unassigned += n_dummy - int((owner == _auction.DUMMY_OWNER).sum())
    meta = {
        # device rounds when the device took part, else the GS engine's
        # bids (the CPU path has no rounds)
        "its": total_rounds if use_device else total_bids,
        "host_bids": total_bids,
        "phases": phases,
        "final_eps": float(eps) / tr.scale,
        "unassigned": unassigned,
        "soln_found": (unassigned == 0
                       and int((sigma[:n_real] < 0).sum()) == 0
                       and eps <= e_min),
        "time": time.perf_counter() - t0,
        "mode": mode,
    }
    return sigma, prices, meta
