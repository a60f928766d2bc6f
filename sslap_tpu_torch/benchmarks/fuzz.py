"""Differential fuzz of the port against the scipy oracles and, on the card,
of the card against the CPU.  Counterpart of ``benchmarks/fuzz.py``.

A randomized sweep over the whole public surface, in five families:

  auction        every mode (cpu / device / hybrid / auto / sharded /
                 overlapped / sharded_hybrid) and engine (compact /
                 candidates / dense), dense or COO input, int or float
                 costs, min or max, rectangular shapes, ties, big
                 magnitudes, keep_assignment=False, pad_to, AuctionConfig,
                 theta, wide_rounds, the max_iter valve, warm re-solves
                 (FR and churn) and structural infeasibility (must raise
                 InfeasibleError, never hang)
  hk             Hopcroft-Karp, cold and warm
  batch          the batched solves: cpu, device and over a mesh
  adapter        the scipy-compatible linear_sum_assignment
  sharded_flags  the sharded hybrid's flag matrix on 1-8 shards

Every family draws, per seed, in the reference's order, so a case's
scenario line equals the reference's for the same seed and family, and a
repro line from either package reproduces the same case in the other.
A case is a plan (every draw: the inputs and keyword arguments of each
public call) and a run of the plan on one device; the draws that follow a
solve do not depend on its result.

With ``--device cuda`` each case runs on the card and is checked against
scipy, then the same plan runs with ``device='cpu'`` (the kernels' plain
versions, on a CPU mesh as wide as the card's) and the two runs must
agree call by call, bit for bit: the solution, the bits of the prices and
every meta key but the timers (``TIMERS``); the batched family compares
instance by instance, and where one side raises, the other must raise the
same exception type.  A case that raises on the card is a failure; it is
never re-run on the CPU.  The run ends with the kernels' launch counts and
the ladder's grid and one-block tail rounds, and fails if a kernel that
its families reach (``REACHES``) launched no time.

Usage:
    python -m sslap_tpu_torch.benchmarks.fuzz --device cpu --family all --iters 50
    python -m sslap_tpu_torch.benchmarks.fuzz --device cuda --family all --iters 100 --seed 0

Exit code 1 on any failure.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import struct
import sys
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment as scipy_lsa
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import maximum_bipartite_matching, \
    min_weight_full_bipartite_matching

# Meta keys that hold wall times: the only keys the card-against-CPU
# oracle leaves out.  Any other key, one added later included, is compared.
TIMERS = ("time", "device_time", "readback_time", "host_gs_time")


# ---------------------------------------------------------------------------
# Instances and oracles (copies of tests/utils.py's)
# ---------------------------------------------------------------------------


def random_sparse_instance(rng, n, m, density, low=1, high=1000,
                           integer=True):
    """Random sparse instance with a planted perfect matching; returns
    (loc [nnz,2], val [nnz], dense_with_forbidden [-1 fill])."""
    mask = rng.random((n, m)) < density
    perm = rng.permutation(m)[:n]
    mask[np.arange(n), perm] = True
    if integer:
        C = rng.integers(low, high, (n, m))
    else:
        C = rng.random((n, m)) * (high - low) + low
    rr, cc = np.nonzero(mask)
    loc = np.stack([rr, cc], axis=1)
    dense = np.where(mask, C, -1).astype(C.dtype if integer else np.float64)
    return loc, C[rr, cc], dense


def scipy_sparse_objective(loc, val, n, m, maximize=False):
    v = val.astype(np.float64)
    sign = -1.0 if maximize else 1.0
    sp = csr_matrix((sign * v, (loc[:, 0], loc[:, 1])), shape=(n, m))
    r, c = min_weight_full_bipartite_matching(sp)
    return float(sign * sp[r, c].sum())


def scipy_dense_objective(dense, maximize=False):
    """Oracle objective for a dense matrix whose negative entries are
    forbidden (replaced by -/+ inf for scipy)."""
    C = np.asarray(dense, np.float64).copy()
    bad = C < 0
    if bad.any():
        C[bad] = np.inf if not maximize else -np.inf
    r, c = scipy_lsa(C, maximize=maximize)
    if bad[r, c].any():
        raise AssertionError("oracle used a forbidden entry")
    return float(np.asarray(dense, np.float64)[r, c].sum())


# ---------------------------------------------------------------------------
# Plans: every draw of a case, in the reference's order
# ---------------------------------------------------------------------------

# Small pools keep the number of distinct shapes bounded.  256/512 engage
# the deeper tier ladders (the 8-shard ladder only becomes multi-tier past
# ~512).
N_POOL = [1, 2, 3, 5, 8, 13, 16, 24, 32, 48, 64, 96, 128, 256, 512]
M_OFF_POOL = [0, 1, 4, 12]

# (mode, weight, square_only).  auto resolves to cpu below the crossover,
# which every pool size is, so it exercises the cpu routing + meta path.
MODES = [
    ("cpu", 4, False),
    ("device", 4, False),
    ("hybrid", 3, False),
    ("auto", 2, False),
    ("sharded", 2, False),
    ("overlapped", 1, True),
    ("sharded_hybrid", 1, True),
]


def pick_mode(rng, square):
    while True:
        modes, weights, sq = zip(*MODES)
        mode = rng.choice(modes, p=np.array(weights) / sum(weights))
        i = modes.index(mode)
        if sq[i] and not square:
            continue
        return str(mode)


@dataclasses.dataclass(frozen=True)
class Ref:
    """An earlier call's result (``key`` of it, when given).  A call whose
    reference is None does not run, nor does any call after it."""
    call: int
    key: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A 1-D mesh of ``size`` entries of the run's device."""
    size: int
    axis: str


@dataclasses.dataclass(frozen=True)
class ConfigSpec:
    """An ``AuctionConfig`` of these fields."""
    fields: Tuple[Tuple[str, Any], ...]


@dataclasses.dataclass
class Call:
    """One public call: ``fn`` names a function of the package, or with
    ``on`` a method of call ``on``'s result (a solver).  A solve with
    ``stop_if_unfound`` ends the run unless it is soln_found, as the
    reference's case returns there."""
    fn: str
    args: tuple = ()
    kwargs: dict = dataclasses.field(default_factory=dict)
    on: Optional[int] = None
    stop_if_unfound: bool = False


@dataclasses.dataclass
class Plan:
    family: str
    seed: int
    scen: str
    mode: str                  # the case's label in the by-mode counts
    calls: List[Call]
    data: dict                 # what the checks read


def plan_auction(seed: int) -> Plan:
    """The reference's one_case."""
    rng = np.random.default_rng(seed)
    n = int(rng.choice(N_POOL))
    square = rng.random() < 0.7
    m = n if square else n + int(rng.choice(M_OFF_POOL))
    square = n == m
    density = float(rng.uniform(0.05, 1.0))
    integer = rng.random() < 0.7
    problem = "max" if rng.random() < 0.4 else "min"
    coo_input = rng.random() < 0.4
    mode = pick_mode(rng, square)
    # candidates is a single-device opt-in engine
    engine = ("candidates"
              if mode == "device" and square and rng.random() < 0.25
              else None)
    card = rng.random() < 0.3
    warm = rng.random() < 0.25
    # dense engine: square hybrid, no warm (it rejects warm_prices); the
    # auto engine also reaches it on dense cases
    if (engine is None and mode == "hybrid" and square and not warm
            and rng.random() < 0.3):
        engine = "dense"
    infeasible = rng.random() < 0.10

    scen = (f"seed={seed} n={n} m={m} dens={density:.2f} "
            f"int={integer} prob={problem} coo={coo_input} mode={mode} "
            f"engine={engine} card={card} warm={warm} infeas={infeasible}")

    # cost regimes: default; a tiny alphabet (ties: the tie-breaks and
    # eviction chains); large-magnitude floats (the eps schedule)
    reg = rng.random()
    if reg < 0.15:
        low, high = 1, 3
        scen += " ties"
    elif reg < 0.25 and not integer:
        low, high = 1e6, 1e7
        scen += " bigmag"
    else:
        low, high = 1, 1000
    loc, val, dense = random_sparse_instance(
        rng, n, m, density, low=low, high=high, integer=integer)

    if infeasible:
        # two rows share one single column (an empty row is rejected at
        # ingest)
        if n < 2:
            infeasible = False
        else:
            col = int(loc[0, 1])
            keep = ~np.isin(loc[:, 0], [0, 1]) | (loc[:, 1] == col)
            loc2 = loc[keep]
            for r in (0, 1):
                if not ((loc2[:, 0] == r) & (loc2[:, 1] == col)).any():
                    loc2 = np.vstack([loc2, [[r, col]]])
            order = np.lexsort((loc2[:, 1], loc2[:, 0]))
            loc = loc2[order]
            val = (rng.integers(1, 1000, len(loc)) if integer
                   else rng.random(len(loc)) * 999 + 1)
            dense = np.full((n, m), -1.0)
            dense[loc[:, 0], loc[:, 1]] = val
            if integer:
                dense = dense.astype(np.int64)

    kwargs = dict(problem=problem, cardinality_check=card or infeasible,
                  mode=mode)
    if engine:
        kwargs["engine"] = engine
    if rng.random() < 0.10 and mode in ("cpu", "device", "hybrid"):
        kwargs["keep_assignment"] = False
        scen += " reset"
    if rng.random() < 0.10 and not coo_input:
        kwargs["pad_to"] = m
        scen += " pad"
    use_config = rng.random() < 0.10
    if use_config:
        scen += " cfg"
    if rng.random() < 0.25:
        kwargs["theta"] = float(rng.choice([2.0, 5.0, 10.0]))
        scen += f" theta={kwargs['theta']}"
    if mode in ("hybrid", "sharded_hybrid") and rng.random() < 0.35:
        kwargs["wide_rounds"] = True
        scen += " wide"
    valve = (not infeasible and mode == "device" and rng.random() < 0.05)
    if valve:
        kwargs["max_iter"] = 2
        scen += " valve"
    if use_config:
        # the same settings through the AuctionConfig bundle
        cfg = ConfigSpec(tuple((k, v) for k, v in kwargs.items()
                               if k != "pad_to"))
        kwargs = ({"pad_to": kwargs["pad_to"]} if "pad_to" in kwargs
                  else {})
        kwargs["config"] = cfg
    if coo_input:
        build = Call("AuctionSolver",
                     kwargs=dict(loc=loc, val=val, shape=(n, m), **kwargs))
    else:
        build = Call("AuctionSolver", args=(dense,), kwargs=kwargs)
    calls = [build, Call("solve", on=0, stop_if_unfound=True)]
    data = dict(n=n, m=m, integer=integer, problem=problem,
                coo_input=coo_input, loc=loc, val=val, dense=dense,
                infeasible=infeasible, valve=valve, warm=False)
    if infeasible:
        return Plan("auction", seed, scen, mode, calls, data)

    if warm:
        data["warm"] = True
        wkw = {}
        if mode in ("cpu", "hybrid") and rng.random() < 0.5:
            # the FR dual tightening must not change the fixed point
            wkw["warm_mode"] = "fr"
            if rng.random() < 0.3:
                wkw["warm_relax"] = float(rng.uniform(0.8, 1.0))
            scen += " fr"
        calls.append(Call("solve", on=0,
                          kwargs=dict(warm_prices=Ref(1, "prices"), **wkw)))
        if wkw and mode in ("cpu", "hybrid") and n == m and not integer:
            # churned instance: drifted values re-solved warm from the
            # stale duals, against a fresh oracle
            val2 = (np.asarray(val, np.float64)
                    * rng.uniform(0.8, 1.25, len(val))).astype(np.float64)
            data["val2"] = val2
            calls.append(Call("AuctionSolver", kwargs=dict(
                loc=loc, val=val2, shape=(n, m), problem=problem, mode=mode,
                cardinality_check=False)))
            calls.append(Call("solve", on=3, kwargs=dict(
                warm_prices=Ref(1, "prices"), warm_mode="fr")))
    return Plan("auction", seed, scen, mode, calls, data)


def plan_hk(seed: int) -> Plan:
    """The reference's hk_case: no planted matching, rows may be empty."""
    rng = np.random.default_rng(seed)
    n = int(rng.choice(N_POOL))
    m = n + int(rng.choice(M_OFF_POOL))
    density = float(rng.uniform(0.02, 0.6))
    mask = rng.random((n, m)) < density
    scen = f"hk seed={seed} n={n} m={m} dens={density:.2f}"
    rr, cc = np.nonzero(mask)
    data = dict(n=n, m=m, mask=mask, rr=rr, cc=cc, mask2=None)
    plan = Plan("hk", seed, scen, "hk", [], data)
    if len(rr) == 0:
        return plan
    plan.calls.append(Call("hopcroft_solve", kwargs=dict(
        loc=np.stack([rr, cc], 1), shape=(n, m))))
    # warm path: ~10% of the edges perturbed, seeded with the stale match
    keep = rng.random(len(rr)) > 0.1
    add = rng.random((n, m)) < density * 0.1
    mask2 = np.zeros((n, m), bool)
    mask2[rr[keep], cc[keep]] = True
    mask2 |= add
    rr3, cc3 = np.nonzero(mask2)
    if len(rr3) == 0:
        return plan
    data["mask2"] = mask2
    loc3 = np.stack([rr3, cc3], 1)
    plan.calls += [
        Call("hopcroft_solve", kwargs=dict(loc=loc3, shape=(n, m),
                                           warm=Ref(0))),
        Call("hopcroft_solve", kwargs=dict(loc=loc3, shape=(n, m)))]
    return plan


def plan_batch(seed: int) -> Plan:
    """The reference's batch_case."""
    rng = np.random.default_rng(seed)
    B = int(rng.choice([2, 3, 4, 8]))
    n = int(rng.choice([5, 8, 16, 24, 32]))
    m = n if rng.random() < 0.7 else n + 4
    density = float(rng.uniform(0.2, 1.0))
    integer = rng.random() < 0.7
    problem = "max" if rng.random() < 0.4 else "min"
    bmode = str(rng.choice(["cpu", "device", "mesh"], p=[0.4, 0.4, 0.2]))
    scen = (f"batch seed={seed} B={B} n={n} m={m} dens={density:.2f} "
            f"int={integer} prob={problem} bmode={bmode}")
    mats = []
    for _ in range(B):
        _, _, dense = random_sparse_instance(
            rng, n, m, density, low=1, high=1000, integer=integer)
        mats.append(dense.astype(np.float64))
    kw = dict(problem=problem)
    if bmode == "mesh":
        kw["mesh"] = MeshSpec(max(d for d in (8, 4, 2, 1) if B % d == 0),
                              "batch")
        kw["mode"] = "device"
    else:
        kw["mode"] = bmode
    calls = [Call("batch_from_dense", args=(np.stack(mats),)),
             Call("auction_solve_batched", args=(Ref(0),), kwargs=kw)]
    return Plan("batch", seed, scen, f"batch/{bmode}", calls,
                dict(B=B, n=n, m=m, integer=integer, problem=problem,
                     mats=mats))


def plan_adapter(seed: int) -> Plan:
    """The reference's adapter_case: negatives allowed, maximize, tall
    matrices through the transpose."""
    rng = np.random.default_rng(seed)
    n = int(rng.choice([3, 8, 16, 24, 32]))
    m = n + int(rng.choice([0, 0, 5, -2])) if n > 4 else n
    maximize = rng.random() < 0.5
    integer = rng.random() < 0.7
    scen = f"adapter seed={seed} n={n} m={m} max={maximize} int={integer}"
    if integer:
        C = rng.integers(-500, 500, (n, m)).astype(np.float64)
    else:
        C = rng.random((n, m)) * 200 - 100
    calls = [Call("linear_sum_assignment", args=(C,),
                  kwargs=dict(maximize=maximize))]
    return Plan("adapter", seed, scen, "adapter", calls,
                dict(n=n, m=m, maximize=maximize, integer=integer, C=C))


def plan_sharded_flags(seed: int) -> Plan:
    """The reference's sharded_flags_case: overlap / ladder_balance /
    trunc / mesh width / wide rounds / warm prices."""
    rng = np.random.default_rng(seed)
    n = int(rng.choice([16, 32, 64, 96, 128, 512, 1024]))
    density = (float(rng.uniform(0.1, 0.8)) if n <= 128
               else float(rng.uniform(0.01, 0.05)))
    integer = rng.random() < 0.7
    problem = "max" if rng.random() < 0.4 else "min"
    ndev = int(rng.choice([1, 2, 4, 8]))
    overlap = rng.random() < 0.4
    balance = rng.random() < 0.4
    wide = rng.random() < 0.4
    trunc = int(rng.choice([0, 4, 64, 256]))
    scen = (f"shflags seed={seed} n={n} dens={density:.2f} int={integer} "
            f"prob={problem} d={ndev} ov={overlap} bal={balance} "
            f"wide={wide} trunc={trunc}")
    loc, val, dense = random_sparse_instance(
        rng, n, n, density, low=1, high=1000, integer=integer)
    mesh = MeshSpec(ndev, "rows")
    calls = [Call("auction_solve_sharded_hybrid", args=(dense,), kwargs=dict(
        mesh=mesh, problem=problem, cardinality_check=False, trunc=trunc,
        overlap=overlap, ladder_balance=balance, wide_rounds=wide,
        balance_floor=int(rng.choice([8, 64, 256]))),
        stop_if_unfound=True)]
    # a warm re-solve through the same entry point must stay optimal
    if rng.random() < 0.3:
        calls.append(Call("auction_solve_sharded_hybrid", args=(dense,),
                          kwargs=dict(
            mesh=mesh, problem=problem, cardinality_check=False, trunc=trunc,
            overlap=overlap, ladder_balance=balance,
            warm_prices=Ref(0, "prices"))))
    return Plan("sharded_flags", seed, scen, f"sharded_hybrid/d={ndev}",
                calls, dict(n=n, integer=integer, problem=problem,
                            dense=dense))


PLANS: Dict[str, Callable[[int], Plan]] = {
    "auction": plan_auction, "hk": plan_hk, "batch": plan_batch,
    "adapter": plan_adapter, "sharded_flags": plan_sharded_flags}


# ---------------------------------------------------------------------------
# Runs: a plan's calls on one device
# ---------------------------------------------------------------------------

# calls whose result is only an input of later calls (never compared)
CONSTRUCTORS = ("AuctionSolver", "batch_from_dense")


@dataclasses.dataclass
class Outcome:
    """One call's result (normalised to numpy and dicts; None for a
    constructor call once the run is over), or the name of the exception
    it raised with its traceback."""
    value: Any = None
    raised: Optional[str] = None
    trace: str = ""


class Backend:
    """Where a plan's calls run: the port's public functions, with its
    device rounds and meshes on ``device``."""

    def __init__(self, device):
        self.device = torch.device(device)

    def functions(self) -> Dict[str, Callable]:
        import sslap_tpu_torch as P
        from sslap_tpu_torch.parallel import auction_solve_sharded_hybrid
        on = functools.partial
        dev = self.device
        return {
            "AuctionSolver": on(P.AuctionSolver, device=dev),
            "hopcroft_solve": P.hopcroft_solve,
            "linear_sum_assignment": on(P.linear_sum_assignment,
                                        device=dev),
            "batch_from_dense": P.batch_from_dense,
            "auction_solve_batched": on(P.auction_solve_batched,
                                        device=dev),
            "auction_solve_sharded_hybrid": auction_solve_sharded_hybrid,
        }

    def mesh(self, spec: MeshSpec):
        from sslap_tpu_torch.parallel import Mesh
        return Mesh([self.device] * spec.size, spec.axis)

    def config(self, spec: ConfigSpec):
        from sslap_tpu_torch.config import AuctionConfig
        return AuctionConfig(**dict(spec.fields))


class _Missing(Exception):
    """A call's reference is None: the run ends before it."""


def _normal(fn: str, value):
    if fn in ("solve", "auction_solve_sharded_hybrid"):
        prices = value.get("prices")
        return dict(sol=np.asarray(value["sol"]),
                    prices=None if prices is None else np.asarray(prices),
                    meta=dict(value["meta"]))
    if fn == "auction_solve_batched":
        sols, metas = value
        return dict(sols=np.asarray(sols),
                    metas=[dict(mt) for mt in metas])
    if fn == "linear_sum_assignment":
        return tuple(np.asarray(a) for a in value)
    if fn == "hopcroft_solve":
        return np.asarray(value)
    return value


def run_plan(plan: Plan, backend: Backend) -> List[Outcome]:
    """Run the plan's calls in order; the run ends at a call that raises,
    at a ``stop_if_unfound`` solve that is not soln_found, and before a
    call whose reference is None."""
    fns = backend.functions()
    outs: List[Outcome] = []

    def resolve(x):
        if isinstance(x, Ref):
            v = outs[x.call].value
            v = v if x.key is None else v[x.key]
            if v is None:
                raise _Missing
            return v
        if isinstance(x, MeshSpec):
            return backend.mesh(x)
        if isinstance(x, ConfigSpec):
            return backend.config(x)
        return x

    for call in plan.calls:
        try:
            args = [resolve(a) for a in call.args]
            kwargs = {k: resolve(v) for k, v in call.kwargs.items()}
        except _Missing:
            break
        fn = (getattr(outs[call.on].value, call.fn) if call.on is not None
              else fns[call.fn])
        try:
            value = _normal(call.fn, fn(*args, **kwargs))
        except Exception as e:   # a case's failure, recorded and reported
            outs.append(Outcome(raised=type(e).__name__,
                                trace=traceback.format_exc(limit=12)))
            break
        outs.append(Outcome(value))
        if call.stop_if_unfound and not value["meta"]["soln_found"]:
            break
    for call, out in zip(plan.calls, outs):
        if call.fn in CONSTRUCTORS:
            out.value = None
    return outs


# ---------------------------------------------------------------------------
# Checks against scipy (the reference's, in its order)
# ---------------------------------------------------------------------------


def _exception(outs: List[Outcome], allowed: Tuple[int, str] = (-1, "")
               ) -> Optional[str]:
    """The first call that raised, unless it is call ``allowed[0]``
    raising ``allowed[1]``."""
    for i, out in enumerate(outs):
        if out.raised and (i, out.raised) != allowed:
            return f"exception during case (call {i}):\n{out.trace}"
    return None


def _assignment_error(sol, D, n) -> Optional[str]:
    if not ((sol >= 0).all() and len(set(sol.tolist())) == n):
        return f"not an injection: {sol}"
    if (D[np.arange(n), sol] < 0).any():
        return "assignment uses a forbidden edge"
    return None


def check_auction(plan: Plan, outs: List[Outcome]) -> Optional[str]:
    d = plan.data
    n, m, integer, problem = d["n"], d["m"], d["integer"], d["problem"]
    if d["infeasible"]:
        err = _exception(outs, (1, "InfeasibleError"))
        if err or outs[1].raised:
            return err
        return "expected InfeasibleError, got a solution"
    err = _exception(outs)
    if err:
        return err
    res = outs[1].value
    sol, meta = res["sol"], res["meta"]
    if d["valve"] and not meta["soln_found"]:
        # the max_iter valve tripped: soln_found False and obj None, never
        # a hang or a bogus answer
        return "valve: obj not None" if meta["obj"] is not None else None
    if not meta["soln_found"]:
        return f"soln_found False: {meta}"
    D = np.asarray(d["dense"], np.float64)
    err = _assignment_error(sol, D, n)
    if err:
        return err
    obj_check = D[np.arange(n), sol].sum()
    if abs(obj_check - meta["obj"]) > 1e-6 * max(1.0, abs(obj_check)):
        return f"meta obj {meta['obj']} != recomputed {obj_check}"
    maximize = problem == "max"
    oracle = (scipy_sparse_objective(d["loc"], d["val"], n, m, maximize)
              if d["coo_input"] else
              scipy_dense_objective(d["dense"], maximize))
    if integer:
        if meta["obj"] != oracle:
            return f"int obj {meta['obj']} != oracle {oracle}"
    else:
        tol = (m + 1) * meta["final_eps"] + 1e-3
        if abs(meta["obj"] - oracle) > tol:
            return (f"float obj {meta['obj']} vs oracle {oracle} "
                    f"beyond tol {tol}")
    if not d["warm"]:
        return None
    if res["prices"] is None:
        return "AuctionSolution missing warm-startable 'prices'"
    meta2 = outs[2].value["meta"]
    if integer and meta2["obj"] != oracle:
        return f"warm re-solve obj {meta2['obj']} != oracle {oracle}"
    if len(plan.calls) > 3:
        meta3 = outs[4].value["meta"]
        if not meta3["soln_found"]:
            return "fr churn warm: soln_found False"
        orc3 = scipy_sparse_objective(d["loc"], d["val2"], n, m, maximize)
        tol3 = (m + 1) * meta3["final_eps"] + 1e-3
        if abs(meta3["obj"] - orc3) > tol3:
            return (f"fr churn warm obj {meta3['obj']} vs oracle {orc3} "
                    f"beyond {tol3}")
    return None


def _match_error(match, mask, what) -> Optional[str]:
    mi = match >= 0
    if mi.any():
        if not mask[np.nonzero(mi)[0], match[mi]].all():
            return f"{what} matched a non-edge"
        if len(set(match[mi].tolist())) != mi.sum():
            return f"{what} matched a column twice"
    return None


def check_hk(plan: Plan, outs: List[Outcome]) -> Optional[str]:
    """Matching size equal to scipy's maximum_bipartite_matching, the
    returned matchings valid, warm size equal to cold."""
    d = plan.data
    err = _exception(outs)
    if err or not outs:
        return err
    match = outs[0].value
    err = _match_error(match, d["mask"], "HK")
    if err:
        return err
    sp = csr_matrix((np.ones(len(d["rr"]), np.int8), (d["rr"], d["cc"])),
                    shape=(d["n"], d["m"]))
    oracle_sz = int((maximum_bipartite_matching(sp, perm_type="column")
                     >= 0).sum())
    if int((match >= 0).sum()) != oracle_sz:
        return f"HK size {(match >= 0).sum()} != scipy {oracle_sz}"
    if d["mask2"] is None:
        return None
    warm_match, cold_match = outs[1].value, outs[2].value
    wsz, csz = int((warm_match >= 0).sum()), int((cold_match >= 0).sum())
    if wsz != csz:
        return f"warm HK size {wsz} != cold {csz}"
    return _match_error(warm_match, d["mask2"], "warm HK")


def check_batch(plan: Plan, outs: List[Outcome]) -> Optional[str]:
    d = plan.data
    err = _exception(outs)
    if err:
        return err
    n, m = d["n"], d["m"]
    sols, metas = outs[1].value["sols"], outs[1].value["metas"]
    for b in range(d["B"]):
        sol, D = sols[b], d["mats"][b]
        if not ((sol >= 0).all() and len(set(sol.tolist())) == n):
            return f"inst {b}: not an injection"
        if (D[np.arange(n), sol] < 0).any():
            return f"inst {b}: forbidden edge used"
        obj = D[np.arange(n), sol].sum()
        oracle = scipy_dense_objective(D, d["problem"] == "max")
        if d["integer"]:
            if obj != oracle:
                return f"inst {b}: obj {obj} != oracle {oracle}"
        else:
            eps = metas[b].get("final_eps", 1e-3)
            if abs(obj - oracle) > (m + 1) * eps + 1e-3:
                return f"inst {b}: obj {obj} vs oracle {oracle}"
    return None


def check_adapter(plan: Plan, outs: List[Outcome]) -> Optional[str]:
    d = plan.data
    err = _exception(outs)
    if err:
        return err
    C, maximize = d["C"], d["maximize"]
    ri, ci = outs[0].value
    r0, c0 = scipy_lsa(C, maximize=maximize)
    ours, ref = C[ri, ci].sum(), C[r0, c0].sum()
    k = min(d["n"], d["m"])
    if len(ri) != k or len(set(zip(ri.tolist(), ci.tolist()))) != k:
        return f"adapter returned {len(ri)} pairs, expected {k}"
    if d["integer"]:
        if ours != ref:
            return f"adapter obj {ours} != scipy {ref}"
    elif abs(ours - ref) > 1e-2 * max(1.0, abs(ref)):
        return f"adapter obj {ours} vs scipy {ref}"
    return None


def check_sharded_flags(plan: Plan, outs: List[Outcome]) -> Optional[str]:
    d = plan.data
    err = _exception(outs)
    if err:
        return err
    n = d["n"]
    sol, meta = outs[0].value["sol"], outs[0].value["meta"]
    if not meta["soln_found"]:
        return f"soln_found False: {meta}"
    D = np.asarray(d["dense"], np.float64)
    if not ((sol >= 0).all() and len(set(sol.tolist())) == n):
        return "not an injection"
    if (D[np.arange(n), sol] < 0).any():
        return "forbidden edge used"
    obj = D[np.arange(n), sol].sum()
    oracle = scipy_dense_objective(d["dense"], d["problem"] == "max")
    if d["integer"]:
        if obj != oracle:
            return f"obj {obj} != oracle {oracle}"
    elif abs(obj - oracle) > (n + 1) * meta["final_eps"] + 1e-3:
        return f"obj {obj} vs oracle {oracle}"
    if len(outs) > 1:
        obj2 = D[np.arange(n), outs[1].value["sol"]].sum()
        if d["integer"] and obj2 != oracle:
            return f"warm obj {obj2} != oracle {oracle}"
    return None


CHECKS = {"auction": check_auction, "hk": check_hk, "batch": check_batch,
          "adapter": check_adapter, "sharded_flags": check_sharded_flags}


# ---------------------------------------------------------------------------
# The card-against-CPU oracle
# ---------------------------------------------------------------------------


def _scalar(x):
    return x.item() if isinstance(x, np.generic) else x


def _diff(a, b, where: str) -> Optional[str]:
    """Where two results differ, bit for bit (None if they do not): arrays
    in dtype, shape and bytes, floats in their bits, dicts in their keys
    but ``TIMERS`` and each value, sequences element by element."""
    a, b = _scalar(a), _scalar(b)
    if isinstance(a, dict) and isinstance(b, dict):
        ka, kb = set(a) - set(TIMERS), set(b) - set(TIMERS)
        if ka != kb:
            return f"{where}: keys {sorted(ka ^ kb)} on one side only"
        for k in sorted(ka):
            got = _diff(a[k], b[k], f"{where}[{k!r}]")
            if got:
                return got
        return None
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        if a.dtype != b.dtype or a.shape != b.shape or \
                np.ascontiguousarray(a).tobytes() != \
                np.ascontiguousarray(b).tobytes():
            return (f"{where}: {a.dtype}{list(a.shape)} != "
                    f"{b.dtype}{list(b.shape)} or different bits")
        return None
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if type(a) is not type(b) or len(a) != len(b):
            return f"{where}: {a!r} != {b!r}"
        for i, (x, y) in enumerate(zip(a, b)):
            got = _diff(x, y, f"{where}[{i}]")
            if got:
                return got
        return None
    if type(a) is not type(b):
        return f"{where}: {a!r} ({type(a).__name__}) != {b!r} " \
               f"({type(b).__name__})"
    if isinstance(a, float):
        return (None if struct.pack("<d", a) == struct.pack("<d", b)
                else f"{where}: {a!r} != {b!r}")
    return None if a == b else f"{where}: {a!r} != {b!r}"


def differ(a: List[Outcome], b: List[Outcome]) -> Optional[str]:
    """The first call at which two runs of one plan differ (None if they
    agree): a call that ran on one side only, a different exception type,
    or a result that differs bit for bit (the batched family instance by
    instance)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x.raised or y.raised:
            if x.raised != y.raised:
                return f"call {i}: raised {x.raised} against {y.raised}"
            continue
        v, w = x.value, y.value
        if isinstance(v, dict) and "metas" in v and isinstance(w, dict) \
                and "metas" in w and len(v["metas"]) == len(w["metas"]):
            for j in range(len(v["metas"])):
                got = _diff(dict(sol=v["sols"][j], meta=v["metas"][j]),
                            dict(sol=w["sols"][j], meta=w["metas"][j]),
                            f"call {i} instance {j}")
                if got:
                    return got
            continue
        got = _diff(v, w, f"call {i}")
        if got:
            return got
    if len(a) != len(b):
        return f"{len(a)} calls ran against {len(b)}"
    return None


# ---------------------------------------------------------------------------
# Launch counts
# ---------------------------------------------------------------------------

# the kernels each family's card runs reach
REACHES = {
    "auction": ("K1", "K2", "ladder", "DK", "commit_keys"),
    "hk": (),
    "batch": ("K1", "K2"),
    "adapter": (),
    "sharded_flags": ("K1", "K2", "commit_keys"),
}
# each kernel's launch counters (K1's single and batched entries, K2's
# commit and its resolve launch alone)
KERNEL_COUNTERS = {"K1": ("bid_topk", "bid_topk_batched"),
                   "K2": ("commit", "resolve"), "ladder": ("ladder_phase",),
                   "DK": ("dense_bid",), "commit_keys": ("commit_keys",)}


def _wrappers() -> dict:
    from sslap_tpu_torch.ops.bid import bid_topk, bid_topk_batched
    from sslap_tpu_torch.ops.commit import commit, commit_keys, resolve
    from sslap_tpu_torch.ops.dense_bid import dense_bid
    from sslap_tpu_torch.ops.ladder import ladder_phase
    return {"bid_topk": bid_topk, "bid_topk_batched": bid_topk_batched,
            "commit": commit, "resolve": resolve, "commit_keys": commit_keys,
            "dense_bid": dense_bid, "ladder_phase": ladder_phase}


def zero_launches() -> None:
    """Set every launch counter, and the ladder's round statistics, to 0."""
    for w in _wrappers().values():
        w.launches = 0
    stats = _wrappers()["ladder_phase"].stats
    for k in stats:
        stats[k] = 0


def launch_counts() -> dict:
    """The launch counters, each kernel's total and the ladder's grid and
    one-block tail rounds."""
    ws = _wrappers()
    per = {k: w.launches for k, w in ws.items()}
    return dict(counters=per,
                kernels={k: sum(per[c] for c in cs)
                         for k, cs in KERNEL_COUNTERS.items()},
                ladder_stats=dict(ws["ladder_phase"].stats))


def unreached(families, kernels: dict) -> List[str]:
    """The kernels the families reach that launched no time."""
    want = {k for f in families for k in REACHES[f]}
    return sorted(k for k in want if kernels[k] == 0)


# ---------------------------------------------------------------------------
# Sweeps
# ---------------------------------------------------------------------------


def case_list(seed: int, iters: int, family: str) -> List[Tuple[str, int]]:
    """(family, seed) of each case: seeds from ``seed`` on, the families
    of ``all`` in turn."""
    fams = list(PLANS) if family == "all" else [family]
    return [(fams[i % len(fams)], seed + i) for i in range(iters)]


def run_case(family: str, seed: int, device
             ) -> Tuple[Plan, List[Outcome], Optional[str]]:
    """Plan the case, run it on ``device`` and check it against scipy;
    returns (plan, outcomes, error or None)."""
    plan = PLANS[family](seed)
    outs = run_plan(plan, Backend(device))
    return plan, outs, CHECKS[family](plan, outs)


def card_device() -> torch.device:
    """The card the fuzz runs on; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device")
    return torch.device("cuda", 0)


def repro(family: str, seed: int, device: str) -> str:
    return (f"python -m sslap_tpu_torch.benchmarks.fuzz --device {device} "
            f"--family {family} --seed {seed} --iters 1")


def sweep(cases: List[Tuple[str, int]], device: str,
          cpu_outcomes: Optional[Callable[[int, str, int], list]] = None,
          progress_every: int = 25, log=print) -> dict:
    """Run ``cases`` on ``device`` ('cpu' or 'cuda'), each checked against
    scipy; on the card every case then is held to its CPU twin, which
    ``cpu_outcomes(i, family, seed)`` gives (default: the plan run here
    with device='cpu').  Returns the summary: cases by family and by mode,
    the failures (scenario, error, repro line) and, on the card, the
    launch counts and the kernels the families reach that never
    launched."""
    on_card = device == "cuda"
    dev = card_device() if on_card else torch.device("cpu")
    if on_card:
        zero_launches()
    if cpu_outcomes is None:
        def cpu_outcomes(i, family, seed):
            return run_plan(PLANS[family](seed), Backend("cpu"))
    failures, by_family, by_mode, ran = [], {}, {}, {}

    def fail(family, seed, scen, err):
        failures.append(dict(scen=scen, err=err,
                             repro=repro(family, seed, device)))
        log(f"FAIL {scen}\n  {err}\n  repro: {repro(family, seed, device)}")

    for i, (family, seed) in enumerate(cases):
        by_family[family] = by_family.get(family, 0) + 1
        try:
            plan, outs, err = run_case(family, seed, dev)
        except Exception:   # the case failed outside a public call
            fail(family, seed, f"seed={seed} fam={family}",
                 "exception during case:\n" + traceback.format_exc(limit=12))
            continue
        by_mode[plan.mode] = by_mode.get(plan.mode, 0) + 1
        if err:
            fail(family, seed, plan.scen, err)
        else:
            ran[i] = (plan.scen, outs)
        if (i + 1) % progress_every == 0:
            log(f"[{i + 1}/{len(cases)}] failures={len(failures)}")
    out = dict(cases=len(cases), by_family=by_family, by_mode=by_mode)
    if on_card:
        out["launches"] = launch_counts()
        out["unreached"] = unreached({f for f, _ in cases},
                                     out["launches"]["kernels"])
        # the card-against-CPU oracle, after every card run
        for i, (scen, outs) in ran.items():
            family, seed = cases[i]
            got = differ(outs, cpu_outcomes(i, family, seed))
            if got:
                fail(family, seed, scen, f"card != cpu: {got}")
    out["failures"] = failures
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--family", choices=[*PLANS, "all"], default="auction")
    ap.add_argument("--progress-every", type=int, default=25)
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda")
    args = ap.parse_args(argv)
    out = sweep(case_list(args.seed, args.iters, args.family), args.device,
                progress_every=args.progress_every)
    if args.device == "cuda":
        print("launches " + json.dumps(out["launches"]), flush=True)
        if out["unreached"]:
            print(f"FAIL kernels never launched: {out['unreached']}",
                  flush=True)
    print(f"done: {args.iters} cases, {len(out['failures'])} failures",
          flush=True)
    sys.exit(1 if out["failures"] or out.get("unreached") else 0)


if __name__ == "__main__":
    main()
