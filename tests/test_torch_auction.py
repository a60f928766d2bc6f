"""The port's Jacobi device path (sslap_tpu_torch.auction: jacobi_round,
dummy_grab_step, unassign_violators, solve_ell) against the JAX package's
(sslap_tpu.auction), on the CPU with the kernels' twins.

Tolerance: exact.  sigma, owner, round and phase counts equal; prices and
eps bit for bit -- every f32 op (w = a - p[col], bid = (a* - v2) + eps,
t + eps, the eps descent) is the same op in the same order on both sides.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sslap_tpu import auction as RA
from sslap_tpu import ingest as RI
from sslap_tpu_torch import auction as PA
from tests.utils import random_sparse_instance


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(seed, n, m, integer, density=0.08):
    """A feasible instance (planted matching) in the solver's transformed
    space, with the reference's schedule for the m-sized square
    extension."""
    rng = np.random.default_rng(seed)
    loc, val, _ = random_sparse_instance(rng, n, m, density,
                                         integer=integer)
    if not integer:
        val = val.astype(np.float32)
    prob = RI.from_coo(loc, val, shape=(n, m))
    vals = np.asarray(prob.vals)
    valid = np.asarray(prob.valid)
    vmax_abs = float(np.abs(vals[valid]).max())
    tr = RA.make_transform("min", m, vals.dtype, vmax_abs)
    e0, e_min, theta = RA.default_eps_schedule(vals.dtype, vmax_abs, m,
                                               tr.scale)
    vals_t = (vals * np.asarray(tr.sign * tr.scale, vals.dtype)).astype(
        vals.dtype)
    dt = vals.dtype.type
    bigp = dt(vals_t[valid].max() - vals_t[valid].min()) + dt(1)
    return dict(n=n, m=m, cols=np.asarray(prob.cols), vals_t=vals_t,
                valid=valid, nvalid=np.asarray(prob.nvalid), e0=e0,
                e_min=e_min, theta=theta, bigp=bigp, dt=dt,
                vals_m=np.where(valid, vals_t, PA.neg_sentinel_np(vals.dtype)))


def _jax(c, *keys):
    return [jnp.asarray(c[k]) for k in keys]


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("shape", [(70, 70), (60, 100)])
def test_round_pieces_match_reference(integer, shape):
    """From each reference state along a solve at fixed eps, one
    jacobi_round, one dummy_grab_step (rectangular) and, at a smaller eps,
    one unassign_violators give the reference's (prices, owner, sigma)."""
    n, m = shape
    c = _case(3, n, m, integer)
    n_dummy = m - n
    cols, vals_t, valid, nvalid = _jax(c, "cols", "vals_t", "valid",
                                       "nvalid")
    eps = c["dt"](max(c["e0"] / 25, c["e_min"]))
    eps_j, bigp_j = jnp.asarray(eps), jnp.asarray(c["bigp"])
    prices = jnp.zeros(m, vals_t.dtype)
    owner = jnp.full((m,), -1, jnp.int32)
    sigma = jnp.full((n,), -1, jnp.int32)
    evictions = 0
    for _ in range(12):
        ref = RA.jacobi_round(cols, vals_t, valid, nvalid, prices, owner,
                              sigma, eps_j, bigp_j)
        got = PA.jacobi_round(_t(c["cols"]), _t(c["vals_m"]),
                              _t(c["nvalid"]), _t(prices), _t(owner),
                              _t(sigma), eps, c["bigp"])
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(_bits(b), _bits(a))
        evictions += int(((np.asarray(sigma) >= 0) &
                          (np.asarray(ref[2]) < 0)).sum())
        prices, owner, sigma = ref
        if n_dummy:
            ref = RA.dummy_grab_step(prices, owner, sigma, eps_j, n_dummy)
            got = PA.dummy_grab_step(_t(prices), _t(owner), _t(sigma), eps,
                                     n_dummy)
            for a, b in zip(ref, got):
                np.testing.assert_array_equal(_bits(b), _bits(a))
            assert int(got[3]) == int(ref[3])
            prices, owner, sigma, _ = ref
    assert evictions > 0
    new_eps = c["dt"](max(eps / 5, c["e_min"]))
    ref = RA.unassign_violators(cols, vals_t, valid, prices, owner, sigma,
                                jnp.asarray(new_eps), n_dummy)
    for vals in ("vals_t", "vals_m"):
        got = PA.unassign_violators(_t(c["cols"]), _t(c[vals]),
                                    _t(c["valid"]), _t(prices), _t(owner),
                                    _t(sigma), new_eps, n_dummy)
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert (np.asarray(ref[1]) < np.asarray(sigma)).any()   # some freed


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("shape", [(80, 80), (60, 100)])
@pytest.mark.parametrize("kw", [dict(), dict(keep_assignment=False),
                                dict(pass_bigp=True, n_global=True)])
def test_solve_ell_matches_reference(integer, shape, kw):
    n, m = shape
    c = _case(4, n, m, integer)
    kw = dict(kw)
    extra = {}
    if kw.pop("pass_bigp", False):
        extra["bigp"] = c["bigp"]
    if kw.pop("n_global", False):
        extra["n_global"] = n
    args = (c["e0"], c["e_min"], c["theta"], RA.default_max_iter(n))
    ref = RA.solve_ell(*_jax(c, "cols", "vals_t", "valid", "nvalid"),
                       jnp.zeros(m, c["vals_t"].dtype), *args, **kw, **extra)
    got = PA.solve_ell(_t(c["cols"]), _t(c["vals_t"]), _t(c["valid"]),
                       _t(c["nvalid"]), torch.zeros(m, dtype=PA.torch_dtype(
                           c["vals_t"].dtype)), *args, **kw, **extra)
    np.testing.assert_array_equal(got.sigma.numpy(), np.asarray(ref.sigma))
    np.testing.assert_array_equal(_bits(got.prices), _bits(ref.prices))
    assert got.rounds == int(ref.rounds) > 0
    assert got.phases == int(ref.phases) > 1
    assert _bits(got.final_eps) == _bits(ref.final_eps)
    assert got.unassigned == int(ref.unassigned) == 0
