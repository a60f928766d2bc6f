"""End-to-end tracking workload on the port: a persistent assignment
problem re-solved frame after frame as its costs drift (object tracking,
sensor fusion).  Counterpart of ``benchmarks/tracking.py``; it composes
the port's three warm paths the way that workload would:

  - ``warm_prices``    the previous frame's dual prices seed the auction
  - ``hopcroft_solve(warm=)``  the previous matching seeds the feasibility
                       re-check when the sparsity pattern changed
  - construct-once     ``AuctionSolver`` device caches

Three drift families over the 1M x 1M / 10 nnz/row headline instance
(``--families ABC``; they run in the order A, C, B and share one random
stream, as in the reference):

  A (values):     costs drift (clipped Gaussian, ``--sigma``), pattern
                  FIXED.  Warm frames skip feasibility and re-solve from
                  the previous frame's prices, chained, with a
                  drift-matched schedule (eps_start = 4 sigma): 2-3 cheap
                  phases instead of the full schedule.  Exactness is
                  unchanged (the last phase still completes at eps_min).
  C (persistent): pattern FIXED, sigma = ``--sigma-persistent`` (<= 0.1%
                  of the cost range) over at least 4 chained frames.
  B (pattern):    0.1% of the edges replaced per frame (plus value drift),
                  the previous MATCHING protected (a tracker's current
                  tracks persist).  Warm frames re-ingest, run a warm
                  Hopcroft-Karp from the previous matching, and warm-start
                  prices (``--warm fr``: FR-tightened duals and eps_start
                  = ``--warm-eps-mult`` sigma).  A warm solve that is not
                  ``soln_found`` is re-solved cold inside the frame (a
                  solver recipe, recorded as ``fell_back``).

Cold frames solve from scratch (fresh solver, full HK, full eps schedule).
Output: one JSON line per frame, then a frames/s summary.  The solves run
on ``--device`` (the card by default); a missing or failing card raises.

Usage: python -m sslap_tpu_torch.benchmarks.tracking [--n 1000000]
           [--frames 3] [--mode hybrid|cpu|auto] [--device cuda|cpu]
           [--warm raw|relax|fr] [--gs-engine forward|fr] [--pad-to K]
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from typing import Callable, Optional

import numpy as np

from sslap_tpu_torch import AuctionSolver as _AuctionSolver
from sslap_tpu_torch import hopcroft_solve

FAMILIES = "ABC"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_instance(n, m, k_extra, seed=0, low=1.0, high=1000.0):
    """Copy of bench.make_instance (bench.py imports jax): k_extra random
    columns per row plus a planted permutation, float32 costs."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), k_extra)
    cols = rng.integers(0, m, n * k_extra, dtype=np.int64)
    perm = rng.permutation(m)[:n].astype(np.int64)
    rr = np.concatenate([rows, np.arange(n, dtype=np.int64)])
    cc = np.concatenate([cols, perm])
    key = rr * m + cc
    _, idx = np.unique(key, return_index=True)
    rr, cc = rr[idx], cc[idx]
    vv = (rng.random(rr.shape[0]) * (high - low) + low).astype(np.float32)
    return rr, cc, vv


def drift_values(val, rng, sigma=10.0, low=1.0, high=1000.0):
    return np.clip(val + rng.standard_normal(val.shape).astype(np.float32)
                   * np.float32(sigma), low, high).astype(np.float32)


def drift_pattern(rr, cc, vv, n, m, n_anchor, rng, frac=1e-3,
                  low=1.0, high=1000.0, protect_keys=None):
    """Replace ``frac`` of the non-anchor edges with fresh random ones.
    The first ``n_anchor`` edges stay put.  ``protect_keys`` (sorted int64
    r*m+c keys, e.g. the previous frame's MATCHING) are exempt from churn
    too: a real tracker's current tracks persist into the next frame, and
    without this the churn can destroy feasibility outright."""
    e = rr.shape[0]
    repl = rng.random(e) < frac
    repl[:n_anchor] = False
    if protect_keys is not None and len(protect_keys):
        repl &= ~np.isin(rr * np.int64(m) + cc, protect_keys)
    k = int(repl.sum())
    rr = rr.copy()
    cc = cc.copy()
    vv = vv.copy()
    rr[repl] = rng.integers(0, n, k)
    cc[repl] = rng.integers(0, m, k)
    vv[repl] = (rng.random(k) * (high - low) + low).astype(np.float32)
    # de-dup (drop later duplicates of the same cell, as ingest would)
    key = rr.astype(np.int64) * m + cc
    _, idx = np.unique(key, return_index=True)
    return rr[idx], cc[idx], vv[idx]


def warm_kwargs(warm: str) -> dict:
    """The warm-price treatment of the warm arms: raw duals, a 0.9
    rollback, or the forward-reverse dual tightening."""
    return ({} if warm == "raw"
            else {"warm_relax": 0.9} if warm == "relax"
            else {"warm_mode": "fr"})


def run_families(n: int = 1_000_000, frames: int = 3, mode: str = "hybrid",
                 device: str = "cuda", families: str = FAMILIES,
                 warm: str = "fr", sigma: float = 10.0,
                 gs_engine: str = "forward", warm_eps_mult: float = 4.0,
                 warm_theta: float = 0.0, sigma_persistent: float = 0.5,
                 pad_to: Optional[int] = None,
                 on_frame: Optional[Callable[[dict], None]] = None):
    """Run the drift families and return ``(records, summary)``: one
    record per frame (the reference's keys) and the frames/s summary.

    ``on_frame(detail)`` is called after each frame, outside its timed
    region, with ``frame`` (its name), ``record`` (None for family B's
    untimed pre-solve), ``metas`` (the meta of every solve in the frame,
    in order: two when a warm B frame fell back), ``sol`` and ``prices``
    (of the frame's last solve), ``hk_s`` and ``fell_back`` (B's warm
    frames; else None and False) and ``churn_s`` (B's cold frames: the
    host seconds of the pattern churn and value drift before the frame,
    outside every frame's time; else None)."""
    if warm not in ("raw", "relax", "fr"):
        raise ValueError(f"unknown warm treatment {warm!r}")
    # One switch flips the host finisher for every arm (cold and warm);
    # pad_to pins the ELL width K of every frame.
    AuctionSolver = functools.partial(_AuctionSolver, gs_engine=gs_engine,
                                      pad_to=pad_to, device=device)
    wkw = warm_kwargs(warm)
    rng = np.random.default_rng(0)
    rr, cc, vv = make_instance(n, n, 9, seed=0)
    log(f"instance: {n}x{n} nnz={rr.shape[0]}")

    results = []

    def frame(name, fn, churn_s=None):
        t0 = time.perf_counter()
        out, detail = fn()
        dt = time.perf_counter() - t0
        rec = {"frame": name, "s": round(dt, 3), **out}
        results.append(rec)
        detail = {"frame": name, "record": rec, "hk_s": None,
                  "fell_back": False, "churn_s": churn_s, **detail}
        if on_frame is not None:
            on_frame(detail)
        return detail

    def solved(*res):
        return {"metas": [r["meta"] for r in res], "sol": res[-1]["sol"],
                "prices": res[-1]["prices"]}

    # ---------------- family A (and C): value drift, fixed pattern --------
    loc = np.stack([rr, cc], 1)

    def value_drift_family(tag, sigma_f, n_frames):
        """Cold-vs-warm frames under fixed-pattern value drift; warm
        prices are CHAINED frame to frame (the real tracker pattern; the
        reference measured raw chained duals accumulating ~sigma relative
        error per frame; the --warm treatment is the mitigation)."""
        def frame0():
            r = AuctionSolver(loc=loc, val=vv, shape=(n, n), mode=mode,
                              cardinality_check=True).solve()
            return ({"obj": r["meta"]["obj"],
                     "host_bids": r["meta"]["host_bids"]}, solved(r))

        prices = frame(f"{tag}0_cold_construct+hk+solve", frame0)["prices"]
        vals_f = vv
        for f in range(1, n_frames + 1):
            vals_f = drift_values(vals_f, rng, sigma=sigma_f)

            def cold(vals_f=vals_f):
                # fresh solver: re-ingest + HK + full schedule
                r = AuctionSolver(loc=loc, val=vals_f, shape=(n, n),
                                  mode=mode, cardinality_check=True).solve()
                return ({"obj": r["meta"]["obj"],
                         "host_bids": r["meta"]["host_bids"]}, solved(r))

            frame(f"{tag}{f}_cold", cold)

            def warm_frame(vals_f=vals_f, prices=prices):
                # no HK (pattern unchanged), chained warm prices,
                # drift-matched schedule (eps_start = 4 sigma)
                r = AuctionSolver(loc=loc, val=vals_f, shape=(n, n),
                                  mode=mode, cardinality_check=False,
                                  eps_start=4.0 * sigma_f
                                  ).solve(warm_prices=prices, **wkw)
                return ({"obj": r["meta"]["obj"],
                         "host_bids": r["meta"]["host_bids"],
                         "phases": r["meta"]["phases"],
                         "found": r["meta"]["soln_found"]}, solved(r))

            prices = frame(f"{tag}{f}_warm", warm_frame)["prices"]

    if "A" in families:
        value_drift_family("A", sigma, frames)
    if "C" in families:
        value_drift_family("C", sigma_persistent, max(frames, 4))

    # ---------------- family B: pattern + value drift ----------------------
    if "B" in families:
        rrB, ccB, vvB = rr, cc, vv
        log("family B: pre-solve")
        rB = AuctionSolver(loc=np.stack([rrB, ccB], 1), val=vvB,
                           shape=(n, n), mode=mode,
                           cardinality_check=False).solve()
        if on_frame is not None:
            on_frame({"frame": "B0_presolve", "record": None, "hk_s": None,
                      "fell_back": False, "churn_s": None, **solved(rB)})
        pricesB, matchB = rB["prices"], rB["sol"]
        del rB

        for f in range(1, frames + 1):
            t0 = time.perf_counter()
            mrows = np.flatnonzero(matchB >= 0).astype(np.int64)
            protect = np.sort(mrows * np.int64(n) + matchB[mrows])
            rrB, ccB, vvB = drift_pattern(rrB, ccB, vvB, n, n, 0, rng,
                                          protect_keys=protect)
            vvB = drift_values(vvB, rng, sigma=sigma)
            locB = np.stack([rrB, ccB], 1)
            churn_s = time.perf_counter() - t0

            def coldB(locB=locB, vvB=vvB):
                r = AuctionSolver(loc=locB, val=vvB, shape=(n, n),
                                  mode=mode,
                                  cardinality_check=True).solve()  # full HK
                return ({"obj": r["meta"]["obj"],
                         "host_bids": r["meta"]["host_bids"],
                         "feasible": r["meta"]["soln_found"]}, solved(r))

            frame(f"B{f}_cold", coldB, churn_s)

            def warmB(locB=locB, vvB=vvB, pricesB=pricesB, matchB=matchB):
                t0 = time.perf_counter()
                mt = hopcroft_solve(loc=locB, shape=(n, n), warm=matchB)
                hk_s = time.perf_counter() - t0
                feasible = bool((mt >= 0).all())
                # FR-tightened duals are dual-feasible for the new costs,
                # so the drift-matched eps_start applies under --warm fr;
                # raw or relaxed duals keep the full schedule
                skw = {}
                if warm == "fr":
                    skw["eps_start"] = warm_eps_mult * sigma
                    if warm_theta:
                        skw["theta"] = warm_theta
                r = AuctionSolver(loc=locB, val=vvB, shape=(n, n),
                                  mode=mode, cardinality_check=False,
                                  **skw).solve(warm_prices=pricesB, **wkw)
                res = [r]
                fell_back = not r["meta"]["soln_found"]
                if fell_back:
                    # bid budget tripped: a cold solve inside the frame
                    r = AuctionSolver(loc=locB, val=vvB, shape=(n, n),
                                      mode=mode,
                                      cardinality_check=False).solve()
                    res.append(r)
                return ({"obj": r["meta"]["obj"], "hk_s": round(hk_s, 3),
                         "host_bids": r["meta"]["host_bids"],
                         "found": r["meta"]["soln_found"],
                         "fell_back": fell_back, "feasible": feasible},
                        dict(solved(*res), hk_s=hk_s, fell_back=fell_back))

            d = frame(f"B{f}_warm", warmB)
            pricesB, matchB = d["prices"], d["sol"]

    def fps(prefix, suffix):
        ts = [r["s"] for r in results
              if r["frame"].startswith(prefix) and r["frame"].endswith(suffix)]
        return round(len(ts) / sum(ts), 3) if ts else None

    summary = {
        "mode": mode, "n": n, "frames": frames, "warm": warm,
        "fps_value_drift_cold": fps("A", "_cold"),
        "fps_value_drift_warm": fps("A", "_warm"),
        "fps_pattern_drift_cold": fps("B", "_cold"),
        "fps_pattern_drift_warm": fps("B", "_warm"),
        "fps_persistent_cold": fps("C", "_cold"),
        "fps_persistent_warm": fps("C", "_warm"),
    }
    return results, summary


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Chained warm re-solves of drifting assignment "
                    "problems (tracking), cold against warm per frame.")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--mode", default="hybrid",
                    choices=["hybrid", "cpu", "auto"])
    ap.add_argument("--device", default="cuda",
                    help="where the device rounds run (cuda, cuda:N, cpu)")
    ap.add_argument("--sigma", type=float, default=10.0,
                    help="per-frame cost drift stddev (cost range 1..1000)")
    ap.add_argument("--warm", default="fr", choices=["raw", "relax", "fr"],
                    help="warm-price treatment for the warm arms: raw "
                         "duals, warm_relax=0.9 rollback, or the "
                         "forward-reverse dual tightening")
    ap.add_argument("--families", default=FAMILIES,
                    help="subset of drift families to run (A=value drift, "
                         "B=pattern churn, C=persistent pattern)")
    ap.add_argument("--gs-engine", default="forward",
                    choices=["forward", "fr"],
                    help="host finisher engine for ALL arms")
    ap.add_argument("--warm-eps-mult", type=float, default=4.0,
                    help="family B fr-warm eps_start = mult * sigma")
    ap.add_argument("--warm-theta", type=float, default=0.0,
                    help="family B fr-warm theta override (0 = default)")
    ap.add_argument("--sigma-persistent", type=float, default=0.5,
                    help="family C per-frame drift stddev (<= 0.1%% of the "
                         "1..1000 cost range)")
    ap.add_argument("--pad-to", type=int, default=None,
                    help="pin the ELL width K of every frame "
                         "(AuctionSolver(pad_to=))")
    args = ap.parse_args(argv)

    def emit(detail):
        if detail["record"] is not None:
            print(json.dumps(detail["record"]), flush=True)

    _, summary = run_families(
        n=args.n, frames=args.frames, mode=args.mode, device=args.device,
        families=args.families, warm=args.warm, sigma=args.sigma,
        gs_engine=args.gs_engine, warm_eps_mult=args.warm_eps_mult,
        warm_theta=args.warm_theta, sigma_persistent=args.sigma_persistent,
        pad_to=args.pad_to, on_frame=emit)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
