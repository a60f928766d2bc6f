"""Public API: auction_solve / AuctionSolver, hopcroft_solve and the
scipy-style linear_sum_assignment.  Counterpart of ``sslap_tpu/api.py``
for the modes the port carries: 'hybrid' (device bulk on ``device`` +
native host tail; square and rectangular), 'device' (the whole eps-scaled
Jacobi auction on ``device``), 'cpu' (native Gauss-Seidel) and 'auto' (the
reference's routing), and the 'dense' engine of mode 'hybrid' (dense
device rounds + native GS tail through the batched dense engine, picked by
engine='auto' for dense-dominated square instances), and 'sharded' and
'overlapped' (the row-sharded Jacobi solves of ``parallel/sharded.py``
and ``parallel/overlap.py`` over every local CUDA device, or over
``device`` when the caller names one or the CPU), and 'sharded_hybrid'
(the row-sharded tiered solve of ``parallel/sharded_compact.py`` with its
host GS tail, over the same mesh).  ``engine='candidates'`` runs the
candidate-list engine (``candidate.py``) as the square device pass of
modes 'hybrid' and 'device'; the other modes ignore it, as the
reference's do.  'auto' routes square instances of at least
``calibrate.crossover()`` rows to 'hybrid'.

Returns a dict-like ``AuctionSolution`` with 'sol' (row -> col), 'meta'
(objective, rounds, phases, final eps, solution-found flag, timing) and
'prices' (the final duals in the solver's transformed space; feed them
back as ``warm_prices=``).
"""

from __future__ import annotations

import time
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from sslap_tpu_torch import auction as _auction
from sslap_tpu_torch import calibrate as _calibrate
from sslap_tpu_torch import candidate as _candidate
from sslap_tpu_torch import compact as _compact
from sslap_tpu_torch import feasibility as _feas
from sslap_tpu_torch import hybrid as _hybrid
from sslap_tpu_torch import ingest as _ingest
from sslap_tpu_torch.config import AuctionConfig, ENGINES, GS_ENGINES, MODES
from sslap_tpu_torch.ingest import ELLProblem
from sslap_tpu_torch.utils import profiling as _prof


class InfeasibleError(ValueError):
    """No perfect matching exists for the given sparsity pattern."""


_UNSET = object()  # "kwarg not given", as distinct from an explicit value


class AuctionSolution(dict):
    """Dict with attribute access: keys 'sol', 'meta', 'prices'."""

    @property
    def sol(self) -> np.ndarray:
        return self["sol"]

    @property
    def meta(self) -> dict:
        return self["meta"]

    @property
    def objective(self):
        return self["meta"]["obj"]


def _ingest_any(mat=None, loc=None, val=None, shape=None, dtype=None,
                pad_to=None) -> ELLProblem:
    if isinstance(mat, ELLProblem):
        if loc is not None or val is not None:
            raise ValueError("pass either mat= or (loc=, val=), not both")
        return mat
    if mat is not None:
        if loc is not None or val is not None:
            raise ValueError("pass either mat= or (loc=, val=), not both")
        return _ingest.from_dense(mat, dtype=dtype, pad_to=pad_to)
    if loc is None or val is None:
        raise ValueError("pass a dense mat= or sparse loc= and val=")
    return _ingest.from_coo(loc, val, shape=shape, dtype=dtype, pad_to=pad_to)


def _objective_host(prob: ELLProblem, sol: np.ndarray):
    """Objective from the original costs in float64/int64 on the host,
    exact whatever the solver dtype."""
    assigned = sol >= 0
    if not assigned.any():
        return 0.0
    rows = np.nonzero(assigned)[0]
    hit = (prob.cols[rows] == sol[rows, None]) & prob.valid[rows]
    slot = hit.argmax(axis=1)
    integral = np.issubdtype(prob.vals.dtype, np.integer) or prob.int_exact
    acc = np.int64 if np.issubdtype(prob.vals.dtype, np.integer) \
        else np.float64
    obj = prob.vals[rows, slot].astype(acc).sum()
    return int(round(float(obj))) if integral else float(obj)


class AuctionSolver:
    """Construct-once solver over an ingested problem; holds the prices of
    the last solve and the device-resident problem data for re-solves.

    ``device``: where the device rounds of modes 'hybrid' (either engine)
    and 'device' run ("cuda" by default; "cpu" runs the kernels' plain
    twins).  A CUDA failure raises: there is no fallback to the CPU path."""

    def __init__(self, mat=None, *, loc=None, val=None,
                 shape: Optional[Tuple[int, int]] = None, problem=_UNSET,
                 eps_start=_UNSET, eps_min=_UNSET, theta=_UNSET,
                 theta_tail=_UNSET, tail_phases=_UNSET, max_iter=_UNSET,
                 cardinality_check=_UNSET, dtype=_UNSET,
                 pad_to: Optional[int] = None, mode=_UNSET,
                 keep_assignment=_UNSET, engine=_UNSET, wide_rounds=_UNSET,
                 fine_ladder=_UNSET, gs_engine=_UNSET, config=None,
                 device="cuda"):
        # explicit kwarg > AuctionConfig > built-in default
        base = (config or AuctionConfig()).solver_kwargs()
        given = dict(problem=problem, eps_start=eps_start, eps_min=eps_min,
                     theta=theta, theta_tail=theta_tail,
                     tail_phases=tail_phases, max_iter=max_iter,
                     cardinality_check=cardinality_check, mode=mode,
                     keep_assignment=keep_assignment, dtype=dtype,
                     engine=engine, wide_rounds=wide_rounds,
                     fine_ladder=fine_ladder, gs_engine=gs_engine)
        kw = {k: base[k] if v is _UNSET else v for k, v in given.items()}
        if kw["gs_engine"] not in GS_ENGINES:
            raise ValueError(f"unknown gs_engine {kw['gs_engine']!r}")
        if kw["mode"] not in MODES:
            raise ValueError(f"unknown mode {kw['mode']!r}")
        if kw["engine"] not in ENGINES:
            raise ValueError(f"unknown engine {kw['engine']!r}")
        theta_tail = kw["theta_tail"]
        if theta_tail is not None and not (theta_tail == 0 or theta_tail > 1):
            raise ValueError("theta_tail must be 0 (off) or > 1")
        if int(kw["tail_phases"]) < 1:
            raise ValueError("tail_phases must be >= 1")

        self.problem_spec = _ingest_any(mat=mat, loc=loc, val=val,
                                        shape=shape, dtype=kw["dtype"],
                                        pad_to=pad_to)
        if self.problem_spec.n == 0:
            raise ValueError("empty problem (no rows)")
        self.problem = kw["problem"]
        self.eps_start = kw["eps_start"]
        self.eps_min = kw["eps_min"]
        self.theta = kw["theta"]
        self.theta_tail = theta_tail
        self.tail_phases = int(kw["tail_phases"])
        self.max_iter = kw["max_iter"]
        self.cardinality_check = kw["cardinality_check"]
        self.mode = kw["mode"]
        self.keep_assignment = kw["keep_assignment"]
        self.engine = kw["engine"]
        self.wide_rounds = kw["wide_rounds"]
        self.fine_ladder = kw["fine_ladder"]
        self.gs_engine = kw["gs_engine"]
        self.device = device
        self.prices: Optional[np.ndarray] = None
        self.meta: Optional[dict] = None
        # problem data on the device (and host CSR/CSC), reused across
        # solve() calls of this solver (see hybrid.solve_hybrid)
        self._device_cache: dict = {}

    def _resolve_mode(self) -> str:
        prob = self.problem_spec
        if prob.vals.dtype == np.float64:
            # float64 rides the host path, as in the reference
            if self.mode in ("device", "hybrid", "sharded", "overlapped",
                             "sharded_hybrid"):
                raise ValueError(
                    "float64 costs are solved on the native CPU path; use "
                    "mode='cpu' or 'auto'")
            return "cpu"
        if self.mode != "auto":
            return self.mode
        if not _hybrid.native_available():
            return "device"     # as the reference: no slow numpy GS
        # 500k unless SSLAP_TPU_CALIBRATE=1 (calibrate.py)
        if prob.n == prob.m and prob.n >= _calibrate.crossover():
            return "hybrid"
        return "cpu"

    def _resolve_engine(self, mode: Optional[str] = None,
                        warm: bool = False) -> str:
        """The reference's pick: engine='auto' is 'dense' for a cold
        mode='hybrid' solve of a dense-dominated instance (nnz * 4 >= n *
        m) that the dense engine accepts, else 'compact'."""
        if self.engine != "auto":
            return self.engine
        if mode == "hybrid" and not warm:
            from sslap_tpu_torch import dense_batch as _db
            prob = self.problem_spec
            if (prob.nnz * 4 >= prob.n * prob.m
                    and _db.dense_hybrid_available(prob)):
                return "dense"
        return "compact"

    def _solve_dense_hybrid(self, prob: ELLProblem, t0, warm_prices
                            ) -> AuctionSolution:
        """One instance through the batched dense engine (B = 1): dense
        [1, n, m] device rounds and one native GS tail.  Its meta already
        counts empty rows in ``unassigned`` and carries the exact
        objective."""
        if warm_prices is not None:
            raise ValueError(
                "engine='dense' does not support warm_prices (its phase "
                "warm starts are internal); use the default engine")
        from sslap_tpu_torch import dense_batch as _db
        from sslap_tpu_torch.batch import stack_problems
        if not _db.dense_hybrid_available(prob):
            raise ValueError(
                "engine='dense' needs a square f32/int32 problem with "
                "n <= 16384 and the native toolchain")
        # the [1, n, K] stack is built once per solver (one solver, one
        # problem, as for the rest of the device cache)
        stacked = self._device_cache.get("dense_stacked")
        if stacked is None:
            stacked = stack_problems([prob])
            self._device_cache["dense_stacked"] = stacked
        sols, metas, prices = _db.solve_batched_dense_hybrid(
            stacked, problem=self.problem, eps_start=self.eps_start,
            eps_min=self.eps_min,
            theta=(5.0 if self.theta is None else self.theta),
            max_iter=self.max_iter, return_prices=True,
            device_cache=self._device_cache, device=self.device)
        self.prices = prices[0]
        # meta 'mode' stays the requested mode; the engine is named beside
        self.meta = dict(metas[0], mode="hybrid", engine="dense",
                         time=time.perf_counter() - t0)
        return AuctionSolution(sol=sols[0], meta=self.meta,
                               prices=self.prices)

    def solve(self, warm_prices=None, warm_relax: float = 1.0,
              warm_mode: str = "raw") -> AuctionSolution:
        """Solve; optionally warm-started from a previous solution's
        ``prices``.  ``warm_relax`` in (0, 1] scales them; ``warm_mode``
        'fr' first applies forward-reverse dual tightening against this
        solve's costs (prices can only fall)."""
        prob = self.problem_spec
        if warm_mode not in ("raw", "fr"):
            raise ValueError("warm_mode must be 'raw' or 'fr'")
        warm_fr = 0
        if warm_prices is not None:
            if not (0.0 < warm_relax <= 1.0):
                raise ValueError("warm_relax must be in (0, 1]")
            warm_prices = _auction.validate_warm_prices(warm_prices, prob.m)
            if warm_relax != 1.0:
                warm_prices = np.asarray(warm_prices) * warm_relax
            if warm_mode == "fr":
                warm_fr = 2
        with _prof.entry():
            return self._solve(prob, warm_prices, warm_fr)

    def _solve(self, prob: ELLProblem, warm_prices,
               warm_fr: int) -> AuctionSolution:
        t0 = time.perf_counter()
        if self.cardinality_check:
            with _prof.span("hk"):
                feasible = _feas.is_feasible(prob)
            if not feasible:
                raise InfeasibleError(
                    "no perfect matching exists for this sparsity pattern "
                    "(detected by Hopcroft-Karp cardinality check; pass "
                    "cardinality_check=False to attempt anyway)")
        mode = self._resolve_mode()
        if mode in ("sharded", "overlapped", "sharded_hybrid"):
            return self._solve_sharded(mode, warm_prices, warm_fr)
        if mode == "device":
            return self._solve_device(prob, warm_prices, t0)
        engine = self._resolve_engine(mode, warm=warm_prices is not None)
        if engine == "dense":
            if mode != "hybrid":
                raise ValueError(
                    "engine='dense' runs dense device rounds with a native "
                    "GS tail -- it requires mode='hybrid'")
            return self._solve_dense_hybrid(prob, t0, warm_prices)
        n_empty = int((prob.nvalid == 0).sum())
        sol, prices, hmeta = _hybrid.solve_hybrid(
            prob, problem=self.problem, eps_start=self.eps_start,
            eps_min=self.eps_min, theta=self.theta,
            theta_tail=self.theta_tail, tail_phases=self.tail_phases,
            max_iter=self.max_iter, mode=mode, warm_prices=warm_prices,
            keep_assignment=self.keep_assignment, engine=engine,
            device_cache=self._device_cache, wide_rounds=self.wide_rounds,
            fine_ladder=self.fine_ladder, warm_fr=warm_fr,
            gs_engine=self.gs_engine, device=self.device)
        unassigned = hmeta["unassigned"] + n_empty
        soln_found = unassigned == 0 and hmeta.get("soln_found", True)
        obj = None
        if soln_found:
            with _prof.span("objective"):
                obj = _objective_host(prob, sol)
        self.prices = prices
        self.meta = dict(hmeta, unassigned=unassigned, soln_found=soln_found,
                         obj=obj, time=time.perf_counter() - t0)
        return AuctionSolution(sol=sol, meta=self.meta, prices=self.prices)

    def _solve_sharded(self, mode: str, warm_prices,
                       warm_fr: int) -> AuctionSolution:
        """mode='sharded' / 'overlapped' / 'sharded_hybrid':
        ``parallel.auction_solve_sharded`` / ``auction_solve_overlapped`` /
        ``auction_solve_sharded_hybrid`` over every local CUDA device
        (``device="cuda"``), or over the one device named (``"cuda:1"``,
        ``"cpu"``).  As in the reference, warm_mode='fr' applies to
        'sharded_hybrid' only (with ``wide_rounds``); elsewhere the port
        warns."""
        from sslap_tpu_torch.parallel import auction_solve_overlapped, \
            auction_solve_sharded, auction_solve_sharded_hybrid, make_mesh
        extra = {}
        if mode == "sharded_hybrid":
            extra = dict(wide_rounds=self.wide_rounds, warm_fr=warm_fr)
        elif warm_fr:
            warnings.warn(f"warm_mode='fr' does not apply to mode={mode!r} "
                          "(the raw warm prices are used)", stacklevel=3)
        dev = torch.device(self.device)
        mesh = make_mesh(None if dev.type == "cuda" and dev.index is None
                         else [dev])
        fn = {"sharded": auction_solve_sharded,
              "overlapped": auction_solve_overlapped,
              "sharded_hybrid": auction_solve_sharded_hybrid}[mode]
        res = fn(
            self.problem_spec, problem=self.problem, mesh=mesh,
            eps_start=self.eps_start, eps_min=self.eps_min,
            theta=self.theta, theta_tail=self.theta_tail,
            tail_phases=self.tail_phases, max_iter=self.max_iter,
            cardinality_check=False, warm_prices=warm_prices, **extra)
        self.prices = res["prices"]
        self.meta = res["meta"]
        return res

    def _solve_device(self, prob: ELLProblem, warm_prices, t0
                      ) -> AuctionSolution:
        """mode='device': square problems that keep the assignment take the
        tiered compacted solve, or the candidate-list solve with
        engine='candidates' (no truncation either way), the rest the
        full-width Jacobi solve, whose keep_assignment=False resets every
        phase (the tiered phase start IS the warm-started violator scan).
        warm_mode='fr' applies to 'hybrid'/'cpu' only, as in the
        reference."""
        tiered = prob.n == prob.m and self.keep_assignment
        engine = self._resolve_engine() if tiered else None
        if engine == "dense":
            raise ValueError(
                "engine='dense' runs dense device rounds with a native GS "
                "tail -- it requires mode='hybrid'")
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but no CUDA device "
                               "is available")
        vals, valid = prob.vals, prob.valid
        vmax_abs = float(np.abs(vals[valid]).max()) if valid.any() else 0.0
        tr = _auction.make_transform(self.problem, prob.m, vals.dtype,
                                     vmax_abs, int_exact=prob.int_exact)
        theta = (self.theta if self.theta is not None
                 else _auction.device_theta_default(prob.n))
        e0, e_min, theta = _auction.default_eps_schedule(
            vals.dtype, vmax_abs, prob.m, tr.scale, eps_min=self.eps_min,
            eps_start=self.eps_start, theta=theta, int_exact=prob.int_exact)
        max_iter = (self.max_iter if self.max_iter is not None
                    else _auction.default_max_iter(prob.n))
        p0 = (np.zeros(prob.m, vals.dtype) if warm_prices is None
              else np.asarray(warm_prices).astype(vals.dtype))
        cols, vals_t, valid_d, nvalid, p0 = (
            torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (prob.cols, tr.apply(vals), valid, prob.nvalid, p0))
        if engine == "candidates":
            res, _ = _candidate.solve_ell_candidates(
                cols, vals_t, valid_d, nvalid, p0, e0, e_min, theta,
                max_iter)
        elif tiered:
            res, _ = _compact.solve_ell_tiered(cols, vals_t, valid_d, nvalid,
                                               p0, e0, e_min, theta,
                                               max_iter)
        else:
            res = _auction.solve_ell(cols, vals_t, valid_d, nvalid, p0, e0,
                                     e_min, theta, max_iter,
                                     keep_assignment=self.keep_assignment)
        sol = res.sigma.cpu().numpy()
        t1 = time.perf_counter()
        # the solve's count leaves out rows with no entries: they are
        # unassignable, so they are folded back in here
        unassigned = res.unassigned + int((prob.nvalid == 0).sum())
        soln_found = unassigned == 0 and _auction.eps_reached(
            res.final_eps, e_min, vals.dtype)
        self.prices = res.prices.cpu().numpy()
        self.meta = {
            "obj": _objective_host(prob, sol) if soln_found else None,
            "its": int(res.rounds),
            "phases": int(res.phases),
            "soln_found": soln_found,
            "final_eps": float(res.final_eps) / tr.scale,
            "unassigned": unassigned,
            "time": t1 - t0,
            "mode": "device",
        }
        return AuctionSolution(sol=sol, meta=self.meta, prices=self.prices)


def auction_solve(mat=None, *, loc=None, val=None,
                  shape: Optional[Tuple[int, int]] = None, problem=_UNSET,
                  eps_start=_UNSET, eps_min=_UNSET, theta=_UNSET,
                  max_iter=_UNSET, cardinality_check=_UNSET, dtype=_UNSET,
                  mode=_UNSET, keep_assignment=_UNSET, engine=_UNSET,
                  config=None, device="cuda") -> AuctionSolution:
    """Solve a (sparse) linear assignment problem with the auction
    algorithm.  ``mat``: dense [n, m] costs, negative / NaN = forbidden;
    or ``loc`` [nnz, 2] + ``val`` [nnz] COO.  See AuctionSolver."""
    solver = AuctionSolver(
        mat, loc=loc, val=val, shape=shape, problem=problem,
        eps_start=eps_start, eps_min=eps_min, theta=theta, max_iter=max_iter,
        cardinality_check=cardinality_check, dtype=dtype, mode=mode,
        keep_assignment=keep_assignment, engine=engine, config=config,
        device=device)
    return solver.solve()


def hopcroft_solve(mat=None, *, loc=None, val=None,
                   shape: Optional[Tuple[int, int]] = None,
                   warm=None) -> np.ndarray:
    """Maximum bipartite matching of the sparsity pattern (values ignored)
    by Hopcroft-Karp on the host (the native matcher shared with the
    reference).  ``warm`` (int [n], col per row, -1 unmatched) seeds the
    augmentation; edges absent from the pattern and duplicate columns are
    dropped first, so a stale matching is safe.

    Returns int64 [n]: matched column per row, -1 if unmatched."""
    if mat is not None:
        prob = _ingest.from_dense(mat)
    else:
        if loc is None:
            raise ValueError("pass mat= or loc= (val optional for matching)")
        if val is None:
            val = np.zeros(np.asarray(loc).shape[0], np.int32)
        prob = _ingest.from_coo(loc, val, shape=shape,
                                require_nonnegative=False)
    init = None
    if warm is not None:
        init = _feas.sanitize_matching(prob, np.asarray(warm))
    match_row, _, _ = _feas.hopcroft_karp(prob, init_match=init)
    return match_row.astype(np.int64)


def linear_sum_assignment(cost, maximize: bool = False, device="cuda"):
    """scipy-compatible adapter: (row_ind, col_ind) for a dense cost matrix
    whose entries are all valid; negative costs are shifted internally, as
    scipy allows them.  Tall matrices (rows > cols) are solved transposed:
    the index arrays then have length ``cols``, row_ind sorted.
    ``device`` as for auction_solve."""
    cost = np.asarray(cost, np.float64)
    shift = min(0.0, float(cost.min())) if cost.size else 0.0
    problem = "max" if maximize else "min"
    n, m = cost.shape
    if n > m:
        col_to_row = auction_solve(cost.T - shift, problem=problem,
                                   device=device)["sol"]
        order = np.argsort(col_to_row, kind="stable")
        return col_to_row[order], order
    sol = auction_solve(cost - shift, problem=problem, device=device)["sol"]
    return np.arange(n), sol
