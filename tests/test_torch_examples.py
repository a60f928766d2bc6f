"""The port's examples (``sslap_tpu_torch/examples``) against the JAX
package's calls on the same inputs, on the CPU (``device="cpu"`` runs the
kernels' plain versions; the distributed example runs on meshes of CPU
shards, the reference on as many virtual CPU devices).

Each example's ``main()`` returns what it prints; objectives, rounds,
solutions, prices (bit for bit) and meta numbers must equal the
reference's.  ``frame_costs`` is taken from ``examples/tracking.py``'s
source (importing that example starts a liveness probe).
"""

import ast
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import sslap_tpu as R
from sslap_tpu import parallel as RP
from sslap_tpu_torch.examples import basic, distributed, tracking

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def reference_frame_costs():
    """``frame_costs`` of examples/tracking.py, compiled from its source
    alone."""
    src = (REPO / "examples" / "tracking.py").read_text()
    fn = next(node for node in ast.parse(src).body
              if isinstance(node, ast.FunctionDef)
              and node.name == "frame_costs")
    scope = {"np": np}
    exec(compile(ast.Module(body=[fn], type_ignores=[]),
                 "examples/tracking.py", "exec"), scope)
    return scope["frame_costs"]


@pytest.mark.parametrize("n,jitter,cand,seed", [
    (50, 0.02, 8, 0), (300, 0.05, 4, 1), (1000, 0.02, 8, 2)])
def test_frame_costs_matches_reference(n, jitter, cand, seed):
    ref = reference_frame_costs()
    base = np.sort(np.random.default_rng(seed).random(n))
    r_rng, p_rng = (np.random.default_rng(seed + 10) for _ in range(2))
    for _ in range(2):      # the stream advances the same way
        r_loc, r_val = ref(r_rng, n, base, jitter=jitter, cand=cand)
        p_loc, p_val = tracking.frame_costs(p_rng, n, base, jitter=jitter,
                                            cand=cand)
        np.testing.assert_array_equal(p_loc, r_loc)
        assert p_val.dtype == r_val.dtype
        np.testing.assert_array_equal(_bits(p_val), _bits(r_val))


def test_basic_matches_reference(capsys):
    n = 300
    got = basic.main(n=n, device="cpu")
    C = np.array([[3.0, 1.0, -1.0], [2.0, -1.0, 5.0], [-1.0, 4.0, 2.0]])
    for key, kw in (("dense_min", {}), ("dense_max", {"problem": "max"})):
        r = R.auction_solve(C, **kw)
        assert got[key] == (r["sol"].tolist(), r["meta"]["obj"])
    loc, val = basic.sparse_instance(n)
    r = R.auction_solve(loc=loc, val=val, shape=(n, n))
    assert got["sparse"] == (r["meta"]["obj"], r["meta"].get("mode"))
    r = R.auction_solve(loc=loc, val=val, shape=(n, n), mode="hybrid")
    assert got["sparse_hybrid"][:2] == (r["meta"]["obj"], r["meta"]["its"])
    np.testing.assert_array_equal(got["sparse_hybrid"][2], r["sol"])
    assert got["matching"] == int((R.hopcroft_solve(
        loc=loc, shape=(n, n)) >= 0).sum()) == n
    with pytest.raises(R.InfeasibleError) as e:
        R.auction_solve(np.array([[5.0, -1.0], [7.0, -1.0]]))
    assert got["infeasible"] == str(e.value).split("(")[0].strip()
    assert "infeasible detected" in capsys.readouterr().out


def test_tracking_example_matches_reference():
    n, frames = 200, 5
    got = tracking.main(n=n, device="cpu", frames=frames)
    frame_costs = reference_frame_costs()
    rng = np.random.default_rng(0)
    base_pos = np.sort(rng.random(n))
    prices = None
    for f in range(frames):
        loc, val = frame_costs(rng, n, base_pos)
        solver = R.AuctionSolver(loc=loc, val=val, shape=(n, n),
                                 mode="device", cardinality_check=False)
        res = solver.solve(warm_prices=prices)
        if f == 1:
            cold = R.AuctionSolver(loc=loc, val=val, shape=(n, n),
                                   mode="device",
                                   cardinality_check=False).solve()
            assert (got["cold_its_frame1"], got["cold_phases_frame1"]) == (
                cold["meta"]["its"], cold["meta"]["phases"])
        prices = solver.prices
        mine = got["frames"][f]
        assert (mine["obj"], mine["its"], mine["phases"]) == (
            res["meta"]["obj"], res["meta"]["its"], res["meta"]["phases"])
        np.testing.assert_array_equal(mine["sol"], res["sol"])
        np.testing.assert_array_equal(_bits(mine["prices"]),
                                      _bits(res["prices"]))
    assert got["checkpoint_ok"]
    loc, _ = frame_costs(rng, n, base_pos)
    cold_match = R.hopcroft_solve(loc=loc, shape=(n, n))
    loc2, _ = frame_costs(rng, n, base_pos)
    warm = R.hopcroft_solve(loc=loc2, shape=(n, n), warm=cold_match)
    assert got["warm_hk_size"] == int((warm >= 0).sum())


@pytest.mark.parametrize("shards", [2, 4])
def test_distributed_example_matches_reference(shards):
    n = 256
    got = distributed.main(n=n, devices=[CPU] * shards)
    assert got["shards"] == shards
    loc, val = distributed.instance(n)
    mesh = RP.make_mesh(devices=jax.devices()[:shards])
    kw = dict(loc=loc, val=val, shape=(n, n), cardinality_check=False)
    single = R.auction_solve(mode="device", **kw)
    sh = RP.auction_solve_sharded(mesh=mesh, **kw)
    hy = RP.auction_solve_sharded_hybrid(mesh=mesh, trunc=64, **kw)
    ov = RP.auction_solve_sharded_hybrid(mesh=mesh, trunc=64, overlap=True,
                                         **kw)
    bal = RP.auction_solve_sharded_hybrid(mesh=mesh, trunc=64,
                                          ladder_balance=True, **kw)
    assert got["single"] == (single["meta"]["obj"], single["meta"]["its"])
    assert got["sharded"][:2] == (sh["meta"]["obj"], sh["meta"]["its"])
    np.testing.assert_array_equal(got["sharded"][2], sh["sol"])
    m = hy["meta"]
    assert got["hybrid"] == (m["obj"], m["its"], m["host_bids"],
                             m["comm_bytes_total"],
                             m["comm_bytes_fullwidth_equiv"])
    assert got["overlap"] == (ov["meta"]["obj"], ov["meta"]["its"])
    assert got["balance"] == (bal["meta"]["obj"],
                              bal["meta"]["ladder_rebuilds"],
                              bal["meta"]["comm_bytes_total"])


def test_examples_raise_without_a_card():
    """No fallback: on a machine without CUDA each example raises where
    the card is asked for (the default), instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tracking.main(n=50, frames=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.main(n=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        basic.main(n=50)
