"""The port's batched solves (sslap_tpu_torch.batch) against the JAX
package's ``sslap_tpu.batch``, on the CPU (``device="cpu"`` runs the
kernels' plain twins; JAX on the CPU).

Tolerance: exact.  ``stack_problems``/``batch_from_dense`` give the same
arrays; the batched Jacobi solve ('device') equals the vmapped reference
per instance (sigma, prices bits, rounds, phases, final eps); 'cpu' and
'hybrid' return the reference's solutions and meta apart from the timers.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sslap_tpu import batch as RB
from sslap_tpu import ingest as RI
from sslap_tpu_torch import auction as PA
from sslap_tpu_torch import batch as PB
from sslap_tpu_torch import dense_batch as PD
from sslap_tpu_torch import ingest as PI
from sslap_tpu_torch import parallel as PP
from tests.utils import random_sparse_instance, scipy_dense_objective

TIMERS = ("time", "device_time", "host_gs_time")


CPU = torch.device("cpu")


def _ref_mesh(k, axis):
    import jax
    from sslap_tpu.parallel import make_mesh
    return make_mesh(devices=jax.devices()[:k], axis_name=axis)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _batch(seed, B, n, m, integer, density=0.3, pad_to=16):
    """The same batch built by both packages."""
    rng = np.random.default_rng(seed)
    rp, pp = [], []
    for _ in range(B):
        loc, val, _ = random_sparse_instance(rng, n, m, density,
                                             integer=integer)
        val = val if integer else val.astype(np.float32)
        rp.append(RI.from_coo(loc, val, shape=(n, m), pad_to=pad_to))
        pp.append(PI.from_coo(loc, val, shape=(n, m), pad_to=pad_to))
    return RB.stack_problems(rp), PB.stack_problems(pp)


def _same_arrays(r, p):
    for f in ("cols", "vals", "valid", "nvalid"):
        a, b = np.asarray(getattr(r, f)), getattr(p, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b)
    assert (r.n, r.m, r.int_exact) == (p.n, p.m, p.int_exact)


def _same_metas(rm, pm):
    assert len(rm) == len(pm)
    for a, b in zip(rm, pm):
        assert set(a) == set(b)
        assert {k: v for k, v in a.items() if k not in TIMERS} == \
            {k: v for k, v in b.items() if k not in TIMERS}


def test_stack_and_batch_from_dense_match_reference():
    rng = np.random.default_rng(0)
    probs = [rng.integers(0, 100, (6, 9)) for _ in range(3)]
    probs[1][probs[1] < 30] = -1                 # forbidden: a smaller K
    _same_arrays(RB.batch_from_dense(np.stack(probs)),
                 PB.batch_from_dense(np.stack(probs)))
    _same_arrays(RB.batch_from_dense(np.stack(probs), dtype=np.float32),
                 PB.batch_from_dense(np.stack(probs), dtype=np.float32))
    r, p = _batch(1, 4, 20, 30, False, pad_to=None)
    _same_arrays(r, p)
    with pytest.raises(ValueError, match="share"):
        PB.stack_problems([PI.from_dense(np.ones((2, 2))),
                           PI.from_dense(np.ones((3, 3)))])
    with pytest.raises(ValueError, match="stack"):
        PB.batch_from_dense(np.ones((3, 3)))


def _schedule(prob, problem):
    vals, valid = np.asarray(prob.vals), np.asarray(prob.valid)
    vmax_abs = float(np.abs(vals[valid]).max())
    tr = PA.make_transform(problem, prob.m, vals.dtype, vmax_abs)
    e0, e_min, theta = PA.default_eps_schedule(vals.dtype, vmax_abs, prob.m,
                                               tr.scale)
    return tr, vals * np.asarray(tr.sign * tr.scale, vals.dtype), e0, e_min, \
        theta


@pytest.mark.parametrize("case", [
    dict(integer=True, B=4, n=40, m=40),
    dict(integer=False, B=4, n=40, m=40),
    dict(integer=True, B=3, n=24, m=32),
    dict(integer=False, B=3, n=24, m=32, problem="max"),
    dict(integer=True, B=4, n=40, m=40, problem="max", max_iter=60),
])
def test_batched_jacobi_matches_vmapped_reference(case):
    """solve_ell_batched against _batched_solve_jit, instance by instance:
    sigma, prices bits, rounds, phases, final eps (a round cap included:
    instances then stop at their own rounds, above eps_min)."""
    case = dict(case)
    r, p = _batch(5, case["B"], case["n"], case["m"], case["integer"])
    tr, vals_t, e0, e_min, theta = _schedule(p, case.get("problem", "min"))
    max_iter = case.get("max_iter", PA.default_max_iter(p.n))
    p0 = np.zeros((case["B"], p.m), vals_t.dtype)
    ref = RB._batched_solve_jit(jnp.asarray(p.cols), jnp.asarray(vals_t),
                                jnp.asarray(p.valid), jnp.asarray(p.nvalid),
                                jnp.asarray(p0), e0, e_min, theta, max_iter,
                                p.n)
    t = torch.from_numpy
    got = PB.solve_ell_batched(t(p.cols), t(vals_t), t(p.valid),
                               t(p.nvalid), t(p0), e0, e_min, theta,
                               max_iter, n_global=p.n)
    np.testing.assert_array_equal(got.sigma.numpy(), np.asarray(ref.sigma))
    np.testing.assert_array_equal(_bits(got.prices), _bits(ref.prices))
    np.testing.assert_array_equal(got.rounds, np.asarray(ref.rounds))
    np.testing.assert_array_equal(got.phases, np.asarray(ref.phases))
    np.testing.assert_array_equal(_bits(got.final_eps),
                                  _bits(ref.final_eps))
    np.testing.assert_array_equal(got.unassigned, np.asarray(ref.unassigned))
    # lanes stop on their own
    assert len(set(zip(got.rounds.tolist(), got.phases.tolist()))) > 1
    if "max_iter" in case:
        assert (got.rounds == max_iter).any()


@pytest.mark.parametrize("case", [
    dict(integer=True), dict(integer=False, problem="max"),
    dict(integer=True, chunk=2), dict(integer=True, warm=True),
])
def test_device_mode_matches_reference(case):
    case = dict(case)
    r, p = _batch(7, 5, 30, 30, case.pop("integer"))
    if case.pop("warm", False):
        rng = np.random.default_rng(8)
        case["warm_prices"] = (rng.random((5, 30)) * 50).astype(
            np.asarray(r.vals).dtype)
    rs, rm = RB.auction_solve_batched(r, mode="device", **case)
    ps, pm = PB.auction_solve_batched(p, mode="device", device="cpu", **case)
    np.testing.assert_array_equal(ps, rs)
    _same_metas(rm, pm)
    assert all(mt["soln_found"] for mt in pm)


def test_cpu_mode_and_auto_match_reference():
    r, p = _batch(9, 4, 40, 40, True, pad_to=14)
    rs, rm = RB.auction_solve_batched(r, mode="cpu")
    ps, pm = PB.auction_solve_batched(p, mode="cpu")
    np.testing.assert_array_equal(ps, rs)
    _same_metas(rm, pm)
    # auto on device='cpu' resolves to 'cpu' with the native runtime, as
    # the reference's auto does
    ps2, pm2 = PB.auction_solve_batched(p, device="cpu")
    np.testing.assert_array_equal(ps2, rs)
    _same_metas(rm, pm2)
    # and to 'device' without it
    from sslap_tpu_torch import hybrid as PH
    orig = PH.native_available
    PH.native_available = lambda: False
    try:
        ps3, pm3 = PB.auction_solve_batched(p, device="cpu")
    finally:
        PH.native_available = orig
    assert "host_bids" not in pm3[0]
    assert [mt["obj"] for mt in pm3] == [mt["obj"] for mt in rm]


@pytest.mark.parametrize("integer", [True, False])
def test_hybrid_mode_matches_reference(integer):
    """The dense-chunk engine through auction_solve_batched (B = 5, n = 48,
    chunk = 2), held to the reference and, for integer costs, to scipy."""
    rng = np.random.default_rng(31)
    n, B = 48, 5
    rp, pp, dense = [], [], []
    for _ in range(B):
        loc, val, d = random_sparse_instance(rng, n, n, 0.2, integer=integer)
        val = val if integer else val.astype(np.float32)
        rp.append(RI.from_coo(loc, val, shape=(n, n), pad_to=24))
        pp.append(PI.from_coo(loc, val, shape=(n, n), pad_to=24))
        dense.append(d)
    r, p = RB.stack_problems(rp), PB.stack_problems(pp)
    rs, rm = RB.auction_solve_batched(r, mode="hybrid", chunk=2)
    ps, pm = PB.auction_solve_batched(p, mode="hybrid", chunk=2,
                                      device="cpu")
    np.testing.assert_array_equal(ps, rs)
    _same_metas(rm, pm)
    assert all(mt["mode"] == "dense-hybrid" and mt["soln_found"]
               for mt in pm)
    if integer:
        assert [mt["obj"] for mt in pm] == [scipy_dense_objective(d)
                                            for d in dense]


def test_auto_mode_routes_to_the_card(monkeypatch):
    """'auto' on a CUDA device takes the dense hybrid where it applies
    (square, no warm prices); everywhere else it picks what the
    reference's 'auto' picks: 'cpu' with the native runtime or for float64
    / int_exact batches, 'device' with a mesh."""
    _, sq = _batch(12, 2, 20, 20, True)
    _, rect = _batch(11, 2, 20, 24, True)
    f64 = PB.batch_from_dense(np.ones((2, 3, 3)), dtype=np.float64)
    pick = PB._auto_mode
    assert pick(sq, False, None, "cuda", False) == "hybrid"
    assert pick(sq, False, None, "cuda:0", True) == "cpu"
    assert pick(rect, False, None, "cuda", False) == "cpu"
    assert pick(f64, True, None, "cuda", False) == "cpu"
    assert pick(sq, False, None, "cpu", False) == "cpu"
    assert pick(sq, False, object(), "cuda", False) == "device"
    # the default call hands a square batch to the dense engine on the card
    seen = {}

    def spy(prob, **kw):
        seen.update(kw, n=prob.n)
        return "dense engine"

    monkeypatch.setattr(PD, "solve_batched_dense_hybrid", spy)
    assert PB.auction_solve_batched(sq) == "dense engine"
    assert seen["device"] == "cuda" and seen["n"] == 20
    # a float64 batch is solved on the host whatever the device
    _, metas = PB.auction_solve_batched(f64)
    assert all(mt["soln_found"] and "host_bids" in mt for mt in metas)


def test_auto_mode_takes_the_cpu_solver_where_the_reference_does(
        monkeypatch):
    """The default call sends a warm-started batch and a rectangular batch
    on device="cuda" to the native 'cpu' solver, as the reference's 'auto'
    does; the warm-started call returns the reference's sols, per-instance
    prices and metas (``mode`` and ``host_bids`` included), on either
    device."""
    from sslap_tpu import hybrid as RH
    from sslap_tpu_torch import hybrid as PH
    B, n = 3, 30
    r, p = _batch(13, B, n, n, True)
    wp = (np.random.default_rng(14).random((B, n)) * 50).astype(
        np.asarray(r.vals).dtype)
    seen, got_prices, ref_prices = [], [], []

    def spy(solve, prices):
        def run(sub, **kw):
            seen.append(kw["mode"])
            out = solve(sub, **kw)
            prices.append(out[1])
            return out
        return run

    monkeypatch.setattr(RH, "solve_hybrid", spy(RH.solve_hybrid, ref_prices))
    monkeypatch.setattr(PH, "solve_hybrid", spy(PH.solve_hybrid, got_prices))
    rs, rm = RB.auction_solve_batched(r, warm_prices=wp)
    assert seen == ["cpu"] * B
    for device in ("cuda", "cpu"):
        seen.clear()
        got_prices.clear()
        ps, pm = PB.auction_solve_batched(p, warm_prices=wp, device=device)
        assert seen == ["cpu"] * B
        np.testing.assert_array_equal(ps, rs)
        _same_metas(rm, pm)
        assert all("mode" in mt and "host_bids" in mt and mt["soln_found"]
                   for mt in pm)
        for a, b in zip(got_prices, ref_prices):
            np.testing.assert_array_equal(_bits(a), _bits(b))
    _, rect = _batch(11, 2, 20, 24, True)
    seen.clear()
    _, metas = PB.auction_solve_batched(rect, device="cuda")
    assert seen == ["cpu"] * 2 and all("host_bids" in mt for mt in metas)


def test_routing_errors_match_reference():
    r, p = _batch(11, 2, 20, 24, True)
    with pytest.raises(ValueError, match="unknown mode"):
        PB.auction_solve_batched(p, mode="fast")
    with pytest.raises(ValueError, match="square"):        # rectangular
        PB.auction_solve_batched(p, mode="hybrid")
    with pytest.raises(ValueError, match="batched hybrid"):
        RB.auction_solve_batched(r, mode="hybrid")
    with pytest.raises(ValueError, match="leading axis"):
        PB.auction_solve_batched(PI.from_dense(np.ones((3, 3))))
    f64 = PB.batch_from_dense(np.ones((2, 3, 3)), dtype=np.float64)
    with pytest.raises(ValueError, match="host path"):
        PB.auction_solve_batched(f64, mode="device", device="cpu")
    # B = 2 over a 3-way mesh: the reference's ValueError
    with pytest.raises(ValueError, match="divide evenly over the 3-way"):
        RB.auction_solve_batched(r, mode="device",
                                 mesh=_ref_mesh(3, "batch"))
    with pytest.raises(ValueError, match="divide evenly over the 3-way"):
        PB.auction_solve_batched(p, mode="device",
                                 mesh=PP.make_mesh([CPU] * 3, "batch"))
    _, sq = _batch(12, 2, 20, 20, True)
    with pytest.raises(ValueError, match="single-device"):
        PB.auction_solve_batched(sq, mode="hybrid", mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PB.auction_solve_batched(sq, mode="device")


@pytest.mark.parametrize("k", [2, 4])
def test_mesh_equals_no_mesh(k):
    """Data parallel over a 'batch' mesh of k CPU entries: each block of
    4 / k instances runs the batched Jacobi solve on its device, and the
    results equal the call without a mesh and the reference's over k of
    its virtual devices (warm prices split with the instances).  'cpu'
    ignores the mesh, as the reference does."""
    r, p = _batch(21, 4, 18, 22, True)
    warm = np.random.default_rng(3).integers(0, 40, (4, 22)).astype(np.int32)
    one = PB.auction_solve_batched(p, mode="device", device="cpu",
                                   warm_prices=warm)
    got = PB.auction_solve_batched(p, mode="device", warm_prices=warm,
                                   mesh=PP.make_mesh([CPU] * k, "batch"))
    ref = RB.auction_solve_batched(r, mode="device", warm_prices=warm,
                                   mesh=_ref_mesh(k, "batch"))
    for a, b in ((got, one), (got, ref)):
        np.testing.assert_array_equal(a[0], b[0])
        _same_metas(b[1], a[1])
    cpu = PB.auction_solve_batched(p, mode="cpu", device="cpu",
                                   mesh=PP.make_mesh([CPU] * k, "batch"))
    np.testing.assert_array_equal(
        cpu[0], PB.auction_solve_batched(p, mode="cpu", device="cpu")[0])
