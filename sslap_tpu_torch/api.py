"""Public API: auction_solve / AuctionSolver.  Counterpart of
``sslap_tpu/api.py`` for the modes the port carries: 'hybrid' (device
bulk on ``device`` + native host tail, square problems), 'cpu' (native
Gauss-Seidel) and 'auto' (the reference's routing between those two).
The other modes and engines raise NotImplementedError (ROADMAP.md).

Returns a dict-like ``AuctionSolution`` with 'sol' (row -> col), 'meta'
(objective, rounds, phases, final eps, solution-found flag, timing) and
'prices' (the final duals in the solver's transformed space; feed them
back as ``warm_prices=``).
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

from sslap_tpu_torch import auction as _auction
from sslap_tpu_torch import feasibility as _feas
from sslap_tpu_torch import hybrid as _hybrid
from sslap_tpu_torch import ingest as _ingest
from sslap_tpu_torch.config import AuctionConfig, ENGINES, GS_ENGINES, MODES
from sslap_tpu_torch.ingest import ELLProblem

# The reference's default auto-mode crossover (sslap_tpu/calibrate.py),
# not yet re-measured on a GPU.
AUTO_HYBRID_MIN_ROWS = 500_000


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


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to sslap_tpu_torch yet (see ROADMAP.md)")


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

    ``device``: where the hybrid's device pass runs ("cuda" by default;
    "cpu" runs the kernels' plain twins).  A CUDA failure raises: there is
    no fallback to the CPU path."""

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
        if kw["mode"] not in ("auto", "hybrid", "cpu"):
            raise _not_ported(f"mode={kw['mode']!r}")
        if kw["engine"] not in ENGINES:
            raise ValueError(f"unknown engine {kw['engine']!r}")
        if kw["engine"] in ("candidates", "dense"):
            raise _not_ported(f"engine={kw['engine']!r}")
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
            if self.mode == "hybrid":
                raise ValueError(
                    "float64 costs are solved on the native CPU path; use "
                    "mode='cpu' or 'auto'")
            return "cpu"
        if self.mode != "auto":
            return self.mode
        if not _hybrid.native_available():
            # the reference's auto picks its pure device mode here
            raise _not_ported("mode='device' (what mode='auto' picks "
                              "without the native host runtime)")
        if prob.n == prob.m and prob.n >= AUTO_HYBRID_MIN_ROWS:
            return "hybrid"
        return "cpu"

    def _check_engine(self, mode: str, warm: bool) -> None:
        """Refuse what the reference's engine='auto' would send to the
        dense engine (square f32/int32, n <= 16384, >= 1/4 dense, native
        host runtime), instead of solving it on another path."""
        prob = self.problem_spec
        if self.engine == "auto" and mode == "hybrid" and not warm:
            if (prob.nnz * 4 >= prob.n * prob.m and prob.n == prob.m
                    and prob.n <= 16384 and not prob.int_exact
                    and _hybrid.native_available()):
                raise NotImplementedError(
                    "engine='auto' picks engine='dense' for this "
                    "dense-dominated instance, and the dense engine is not "
                    "ported to sslap_tpu_torch yet (see ROADMAP.md); pass "
                    "engine='compact'")

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
        t0 = time.perf_counter()
        if self.cardinality_check and not _feas.is_feasible(prob):
            raise InfeasibleError(
                "no perfect matching exists for this sparsity pattern "
                "(detected by Hopcroft-Karp cardinality check; pass "
                "cardinality_check=False to attempt anyway)")
        mode = self._resolve_mode()
        self._check_engine(mode, warm=warm_prices is not None)
        n_empty = int((prob.nvalid == 0).sum())
        sol, prices, hmeta = _hybrid.solve_hybrid(
            prob, problem=self.problem, eps_start=self.eps_start,
            eps_min=self.eps_min, theta=self.theta,
            theta_tail=self.theta_tail, tail_phases=self.tail_phases,
            max_iter=self.max_iter, mode=mode, warm_prices=warm_prices,
            keep_assignment=self.keep_assignment, engine="compact",
            device_cache=self._device_cache, wide_rounds=self.wide_rounds,
            fine_ladder=self.fine_ladder, warm_fr=warm_fr,
            gs_engine=self.gs_engine, device=self.device)
        unassigned = hmeta["unassigned"] + n_empty
        soln_found = unassigned == 0 and hmeta.get("soln_found", True)
        self.prices = prices
        self.meta = dict(hmeta, unassigned=unassigned, soln_found=soln_found,
                         obj=(_objective_host(prob, sol) if soln_found
                              else None),
                         time=time.perf_counter() - t0)
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
