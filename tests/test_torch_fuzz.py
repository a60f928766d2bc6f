"""The port's differential fuzz (``sslap_tpu_torch.benchmarks.fuzz``)
against the reference's (``benchmarks/fuzz.py``), on the CPU.

- for seeds 0-3 of every family, the reference's fuzz and the port's print
  the same scenario line, and neither reports a failure;
- for seeds 0-7 of ``auction``, ``batch`` and ``sharded_flags``, the
  reference's public calls run on the port's plans give the port's
  results with ``device='cpu'``: the same ``sol``, the same price bits and
  every meta key but the timers, instance by instance (the oracle the
  fuzz holds the card to, with the reference on the CPU side);
- the port's copies of the generators and oracles equal ``tests/utils.py``'s;
- the comparator finds one flipped price bit, one differing meta key, a
  key the timer tuple does not name and a different exception type;
- ``--device cuda`` raises without a card; the CLI on the CPU exits 0.
"""

import dataclasses
import functools
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import sslap_tpu as R
import sslap_tpu_torch as P
import sslap_tpu.batch as RB
import sslap_tpu.parallel.mesh as RM
from sslap_tpu.config import AuctionConfig as RConfig
from sslap_tpu.parallel.sharded_compact import \
    auction_solve_sharded_hybrid as r_sharded_hybrid
from sslap_tpu_torch.benchmarks import fuzz as F
from tests import utils as U

REPO = Path(__file__).resolve().parent.parent


def _reference_fuzz():
    """benchmarks/fuzz.py loaded from its path (the JAX settings it makes
    at import are the ones tests/conftest.py already made)."""
    spec = importlib.util.spec_from_file_location(
        "reference_fuzz", REPO / "benchmarks" / "fuzz.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference_fuzz()
REF_CASES = {"auction": REF.one_case, "hk": REF.hk_case,
             "batch": REF.batch_case, "adapter": REF.adapter_case,
             "sharded_flags": REF.sharded_flags_case}


@functools.lru_cache(maxsize=None)
def _port_case(family, seed):
    """The port's case on the CPU: (plan, outcomes, error)."""
    return F.run_case(family, seed, "cpu")


class ReferenceBackend(F.Backend):
    """A plan's calls through the reference's public functions, its meshes
    over the conftest's virtual CPU devices."""

    def __init__(self):
        super().__init__("cpu")

    def functions(self):
        return {"AuctionSolver": R.AuctionSolver,
                "hopcroft_solve": R.hopcroft_solve,
                "linear_sum_assignment": R.linear_sum_assignment,
                "batch_from_dense": RB.batch_from_dense,
                "auction_solve_batched": RB.auction_solve_batched,
                "auction_solve_sharded_hybrid": r_sharded_hybrid}

    def mesh(self, spec):
        return JaxMesh(np.asarray(jax.devices()[:spec.size]), (spec.axis,))

    def config(self, spec):
        return RConfig(**dict(spec.fields))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("family", list(F.PLANS))
def test_scenario_lines_match_reference(family, seed):
    ref_scen, ref_err = REF_CASES[family](seed)
    plan, _, err = _port_case(family, seed)
    assert plan.scen == ref_scen
    assert ref_err is None and err is None, (ref_err, err)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("family", ["auction", "batch", "sharded_flags"])
def test_reference_calls_on_port_plans_match(family, seed, monkeypatch):
    """The modes 'sharded', 'overlapped' and 'sharded_hybrid' of
    AuctionSolver run over every local device: one CPU device in the port,
    and in the reference its default mesh, cut here to one virtual device
    so that the shard-count-dependent meta keys compare too."""
    make_mesh = RM.make_mesh
    monkeypatch.setattr(RM, "make_mesh", lambda devices=None,
                        axis_name="rows": make_mesh(
                            devices or jax.devices()[:1], axis_name))
    plan, port, err = _port_case(family, seed)
    assert err is None, err
    ref = F.run_plan(plan, ReferenceBackend())
    assert F.differ(ref, port) is None, (plan.scen, F.differ(ref, port))
    assert len(ref) == len(plan.calls) or plan.data.get("valve")


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n,m,density", [(1, 1, 0.5), (13, 17, 0.3),
                                         (64, 64, 0.05), (32, 44, 1.0)])
def test_generators_and_oracles_match_tests_utils(n, m, density, integer):
    a, b = np.random.default_rng(n * 31 + m), np.random.default_rng(n * 31 + m)
    got = F.random_sparse_instance(a, n, m, density, low=1, high=50,
                                   integer=integer)
    want = U.random_sparse_instance(b, n, m, density, low=1, high=50,
                                    integer=integer)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert a.random() == b.random()
    loc, val, dense = want
    for maximize in (False, True):
        assert F.scipy_sparse_objective(loc, val, n, m, maximize) == \
            U.scipy_sparse_objective(loc, val, n, m, maximize)
        assert F.scipy_dense_objective(dense, maximize) == \
            U.scipy_dense_objective(dense, maximize)


def _solution_outcomes():
    """Seed 3's auction case: a COO float solve that keeps its prices."""
    plan, outs, _ = _port_case("auction", 3)
    assert outs[1].value["prices"] is not None
    return [dataclasses.replace(o) for o in outs]


def _flip_price_bit(outs):
    p = outs[1].value["prices"].copy()
    p.view(np.uint8)[0] ^= 1
    outs[1].value = dict(outs[1].value, prices=p)


def _change_meta(key, value):
    def change(outs):
        outs[1].value = dict(outs[1].value,
                             meta=dict(outs[1].value["meta"], **{key: value}))
    return change


def _raise(name):
    def change(outs):
        outs[1] = F.Outcome(raised=name)
    return change


@pytest.mark.parametrize("change,caught", [
    (lambda outs: None, False),
    (_flip_price_bit, True),
    (_change_meta("its", -1), True),
    (_change_meta("not_a_timer_s", 0.0), True),
    (_change_meta("time", -1.0), False),           # a timer: not compared
    (_raise("RuntimeError"), True),
])
def test_comparator_has_teeth(change, caught):
    a, b = _solution_outcomes(), _solution_outcomes()
    change(b)
    assert (F.differ(a, b) is not None) == caught


def test_comparator_takes_the_exception_type():
    same = [F.Outcome(raised="InfeasibleError")]
    assert F.differ(same, [F.Outcome(raised="InfeasibleError")]) is None
    assert F.differ(same, [F.Outcome(raised="ValueError")]) is not None
    assert F.differ(same, [F.Outcome(value=1)]) is not None


def test_comparator_checks_batched_instances():
    _, outs, _ = _port_case("batch", 2)
    other = [dataclasses.replace(o) for o in outs]
    metas = [dict(mt) for mt in outs[1].value["metas"]]
    metas[-1]["its"] += 1
    other[1].value = dict(outs[1].value, metas=metas)
    got = F.differ(outs, other)
    assert got is not None and f"instance {len(metas) - 1}" in got


def test_device_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        F.main(["--device", "cuda", "--iters", "1"])


def test_cli_on_the_cpu_exits_zero():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "sslap_tpu_torch.benchmarks.fuzz",
         "--device", "cpu", "--family", "all", "--iters", "10"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    assert "done: 10 cases, 0 failures" in out.stdout


VALVE_SEED = 10734   # an auction case whose max_iter=2 stops after phase 1


@pytest.mark.parametrize("path", ["device", "sharded", "overlapped",
                                  "batched"])
def test_a_round_cap_above_eps_min_is_no_solution(path):
    """Found by the fuzz on the card (auction seed 10734, mode='device',
    max_iter=2): a round cap that stops the eps schedule between phases
    with every row assigned left soln_found True and a non-optimal obj
    (2764 against scipy's 2628), as the reference still does.  The port
    reports soln_found False and obj None at every cap that stops above
    eps_min, and the optimum once the schedule completes."""
    plan = F.PLANS["auction"](VALVE_SEED)
    kw = dict(plan.calls[0].kwargs)
    assert kw["max_iter"] == 2 and kw["mode"] == "device"
    if path == "device":
        ref = R.AuctionSolver(**kw).solve()["meta"]
        assert ref["soln_found"] and ref["obj"] == 2764   # the reference
        assert F.run_case("auction", VALVE_SEED, "cpu")[2] is None
    d = plan.data
    oracle = F.scipy_sparse_objective(d["loc"], d["val"], 13, 13)
    stopped = 0
    for cap in (1, 2, 3, 5, 8, 13, None):
        if path == "batched":
            prob = P.from_coo(d["loc"], d["val"], shape=(13, 13))
            _, metas = P.auction_solve_batched(
                P.stack_problems([prob, prob]), mode="device", max_iter=cap,
                device="cpu")
            meta = metas[1]
        else:
            meta = P.AuctionSolver(**dict(kw, mode=path, max_iter=cap),
                                   device="cpu").solve()["meta"]
        if meta["final_eps"] > 1 / 14:
            stopped += 1
            assert not meta["soln_found"] and meta["obj"] is None, (cap, meta)
        else:
            assert meta["soln_found"] and meta["obj"] == oracle, (cap, meta)
    assert stopped
