"""The port's tracking harness (``sslap_tpu_torch.benchmarks.tracking``)
against the reference's (``benchmarks/tracking.py``), on the CPU.

- the generators are bit-identical to ``bench.make_instance`` and to the
  reference harness's ``drift_values`` / ``drift_pattern``;
- end to end, the reference harness (JAX on the CPU, in a subprocess) and
  ``python -m sslap_tpu_torch.benchmarks.tracking --device cpu`` print
  equal frame records (all keys but the timers ``s`` and ``hk_s``);
- warm state crosses between the packages: the reference's frame-k prices
  (and matching) fed to the port's frame-(k+1) warm solve give the
  reference's frame k+1 bit for bit, and the other way round;
- ``pad_to`` does not change a family-B chain; a missing card raises.
"""

import importlib.util
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import bench
import sslap_tpu as R
import sslap_tpu_torch as P
from sslap_tpu_torch.benchmarks import tracking as T

REPO = Path(__file__).resolve().parent.parent
TIMERS = ("s", "hk_s")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _reference_harness():
    """benchmarks/tracking.py loaded from its path; the JAX settings it
    makes at import (a persistent compilation cache) are undone."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    before = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(
        "reference_tracking", REPO / "benchmarks" / "tracking.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in before.items():
            jax.config.update(k, v)
    return mod


REF = _reference_harness()


@pytest.mark.parametrize("n,m,k,seed", [
    (100, 100, 9, 0), (1000, 1500, 4, 3), (20_000, 20_000, 9, 0)])
def test_make_instance_matches_bench(n, m, k, seed):
    for a, b in zip(T.make_instance(n, m, k, seed=seed),
                    bench.make_instance(n, m, k, seed=seed)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("sigma", [10.0, 0.5, 300.0])
def test_drift_values_matches_reference(sigma):
    _, _, vv = T.make_instance(500, 500, 9, seed=1)
    a_rng, b_rng = np.random.default_rng(5), np.random.default_rng(5)
    a, b = vv, vv
    for _ in range(3):
        a = T.drift_values(a, a_rng, sigma=sigma)
        b = REF.drift_values(b, b_rng, sigma=sigma)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("protect", [False, True])
@pytest.mark.parametrize("frac,n_anchor", [(1e-3, 0), (0.05, 0),
                                           (0.05, 300)])
def test_drift_pattern_matches_reference(protect, frac, n_anchor):
    n = 2000
    rr, cc, vv = T.make_instance(n, n, 9, seed=2)
    keys = None
    if protect:
        sol = R.AuctionSolver(loc=np.stack([rr, cc], 1), val=vv,
                              shape=(n, n), mode="cpu").solve()["sol"]
        rows = np.flatnonzero(sol >= 0).astype(np.int64)
        keys = np.sort(rows * np.int64(n) + sol[rows])
    a_rng, b_rng = np.random.default_rng(9), np.random.default_rng(9)
    a = b = (rr, cc, vv)
    for _ in range(2):
        a = T.drift_pattern(*a, n, n, n_anchor, a_rng, frac=frac,
                            protect_keys=keys)
        b = REF.drift_pattern(*b, n, n, n_anchor, b_rng, frac=frac,
                              protect_keys=keys)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(_bits(x), _bits(y))
    if protect:     # the protected matching survives the churn
        kept = np.isin(keys, a[0] * np.int64(n) + a[1])
        assert kept.all()


def _run(cmd):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("mode,warm,gs_engine", [
    ("hybrid", "fr", "forward"),
    ("cpu", "relax", "forward"),
    ("hybrid", "raw", "fr"),
])
def test_harness_matches_reference(mode, warm, gs_engine):
    args = ["--n", "2000", "--frames", "1", "--mode", mode, "--warm", warm,
            "--gs-engine", gs_engine]
    with ThreadPoolExecutor(2) as ex:
        ref = ex.submit(_run, [sys.executable, "benchmarks/tracking.py",
                               *args])
        port = ex.submit(_run, [sys.executable, "-m",
                                "sslap_tpu_torch.benchmarks.tracking",
                                *args, "--device", "cpu"])
        ref, port = ref.result(), port.result()
    # A0 + A1 cold/warm, C0 + 4 cold/warm, B1 cold/warm, the summary
    assert len(ref) == len(port) == 3 + 9 + 2 + 1
    for r, p in zip(ref[:-1], port[:-1]):
        assert {k: v for k, v in p.items() if k not in TIMERS} == \
            {k: v for k, v in r.items() if k not in TIMERS}
        assert set(p) == set(r)
    assert [r["frame"] for r in ref[:-1]][-1] == "B1_warm"
    assert all(r.get("found", True) and r.get("feasible", True)
               for r in port[:-1])
    assert set(port[-1]) == set(ref[-1])
    for k in ("mode", "n", "frames", "warm"):
        assert port[-1][k] == ref[-1][k]


def _solve(pkg, loc, val, n, mode, warm=None, prices=None, **kw):
    kw = dict(kw, mode=mode, cardinality_check=False)
    if pkg is P:
        kw["device"] = "cpu"
    if warm == "fr":
        kw["eps_start"] = kw.get("eps_start", 40.0)
    s = pkg.AuctionSolver(loc=loc, val=val, shape=(n, n), **kw)
    return s.solve() if prices is None else s.solve(
        warm_prices=prices, **T.warm_kwargs(warm))


def _same(a, b):
    np.testing.assert_array_equal(a["sol"], b["sol"])
    np.testing.assert_array_equal(_bits(a["prices"]), _bits(b["prices"]))
    for k in ("its", "phases", "host_bids", "soln_found", "obj"):
        assert a["meta"][k] == b["meta"][k], k


@pytest.mark.parametrize("mode,warm", [("hybrid", "fr"), ("hybrid", "raw"),
                                       ("cpu", "fr")])
@pytest.mark.parametrize("first", ["reference", "port"])
def test_value_drift_state_crosses_between_packages(mode, warm, first):
    """Family A's chain: frame k's prices from one package seed frame
    k+1's warm solve in the other, which gives the other package's own
    frame k+1 (sol, prices bits, its, phases, host bids)."""
    n, sigma = 1500, 10.0
    rr, cc, vv = T.make_instance(n, n, 9, seed=0)
    loc = np.stack([rr, cc], 1)
    src, dst = (R, P) if first == "reference" else (P, R)
    rng = np.random.default_rng(0)
    prices = _solve(src, loc, vv, n, mode)["prices"]
    vals = vv
    for _ in range(2):
        vals = T.drift_values(vals, rng, sigma=sigma)
        kw = dict(eps_start=4.0 * sigma)
        own = _solve(src, loc, vals, n, mode, warm, prices, **kw)
        crossed = _solve(dst, loc, vals, n, mode, warm, prices, **kw)
        _same(crossed, own)
        assert own["meta"]["soln_found"]
        prices = own["prices"]


@pytest.mark.parametrize("first", ["reference", "port"])
def test_pattern_churn_state_crosses_between_packages(first):
    """Family B's frame: the other package's matching seeds the warm
    Hopcroft-Karp and its prices the warm FR solve on the churned
    pattern (K pinned, so the reference compiles one shape)."""
    n, sigma = 1500, 10.0
    rr, cc, vv = T.make_instance(n, n, 9, seed=0)
    src, dst = (R, P) if first == "reference" else (P, R)
    rng = np.random.default_rng(0)
    prev = _solve(src, np.stack([rr, cc], 1), vv, n, "hybrid", pad_to=24)
    for _ in range(2):
        match = prev["sol"]
        rows = np.flatnonzero(match >= 0).astype(np.int64)
        protect = np.sort(rows * np.int64(n) + match[rows])
        rr, cc, vv = T.drift_pattern(rr, cc, vv, n, n, 0, rng,
                                     protect_keys=protect)
        vv = T.drift_values(vv, rng, sigma=sigma)
        loc = np.stack([rr, cc], 1)
        np.testing.assert_array_equal(
            P.hopcroft_solve(loc=loc, shape=(n, n), warm=match),
            R.hopcroft_solve(loc=loc, shape=(n, n), warm=match))
        kw = dict(eps_start=4.0 * sigma, pad_to=24)
        own = _solve(src, loc, vv, n, "hybrid", "fr", prev["prices"], **kw)
        crossed = _solve(dst, loc, vv, n, "hybrid", "fr", prev["prices"],
                         **kw)
        _same(crossed, own)
        prev = own


def test_pad_to_does_not_change_a_family_b_chain():
    runs = []
    for pad_to in (None, 24):
        details = []
        records, _ = T.run_families(n=2000, frames=2, mode="hybrid",
                                    device="cpu", families="B",
                                    pad_to=pad_to, on_frame=details.append)
        runs.append((records, details))
    (ra, da), (rb, db) = runs
    assert [d["frame"] for d in da] == ["B0_presolve", "B1_cold", "B1_warm",
                                        "B2_cold", "B2_warm"]
    for a, b in zip(ra, rb):
        assert {k: v for k, v in a.items() if k not in TIMERS} == \
            {k: v for k, v in b.items() if k not in TIMERS}
    for a, b in zip(da, db):
        np.testing.assert_array_equal(a["sol"], b["sol"])
        np.testing.assert_array_equal(_bits(a["prices"]), _bits(b["prices"]))
        assert [m["its"] for m in a["metas"]] == [m["its"] for m in b["metas"]]
        assert a["fell_back"] == b["fell_back"]


def test_harness_raises_without_a_card():
    """No fallback to the CPU: the harness's default device is the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.run_families(n=50, frames=1, families="A")


def test_run_families_rejects_an_unknown_warm_treatment():
    with pytest.raises(ValueError, match="warm"):
        T.run_families(n=50, frames=1, warm="cold", device="cpu")
