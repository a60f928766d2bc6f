"""The port's tiered compacted solve (sslap_tpu_torch.compact) against the
JAX package's (sslap_tpu.compact), on the CPU with the kernels' twins.

Tolerance: exact.  sigma, owner and round counts equal; prices and eps bit
for bit -- every f32 op (w = a - p[col], bid = (a* - v2) + eps, the eps
descent) is the same op in the same order on both sides.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from sslap_tpu import auction as RA
from sslap_tpu import compact as RC
from sslap_tpu import ingest as RI
from sslap_tpu.ops.widebid import build_wide_layout
from sslap_tpu_torch import auction as PA
from sslap_tpu_torch import compact as PC
from sslap_tpu_torch import hybrid as PH


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(seed, n, integer, contended=False, k=8, theta=5.0):
    """A square instance like bench.make_instance (k random columns per row
    plus a planted permutation); ``contended`` makes costs follow the
    column, so most rows want the same few columns."""
    rng = np.random.default_rng(seed)
    rr = np.concatenate([np.repeat(np.arange(n), k), np.arange(n)])
    cc = np.concatenate([rng.integers(0, n, n * k), rng.permutation(n)])
    _, idx = np.unique(rr * n + cc, return_index=True)
    rr, cc = rr[idx], cc[idx]
    if contended:
        cost = (cc * 37) % 997 + rng.integers(0, 3, rr.shape[0]) + 1
    else:
        cost = rng.integers(1, 1000, rr.shape[0])
    val = cost if integer else (cost + rng.random(rr.shape[0])).astype(
        np.float32)
    prob = RI.from_coo(np.stack([rr, cc], 1), val, shape=(n, n))
    vals = np.asarray(prob.vals)
    valid = np.asarray(prob.valid)
    vmax_abs = float(np.abs(vals[valid]).max())
    tr = RA.make_transform("min", n, vals.dtype, vmax_abs)
    e0, e_min, th = RA.default_eps_schedule(vals.dtype, vmax_abs, n,
                                            tr.scale, theta=theta)
    ss = tr.sign * tr.scale
    return dict(prob=prob, n=n, cols=np.asarray(prob.cols), vals=vals,
                valid=valid, nvalid=np.asarray(prob.nvalid),
                vals_t=(vals * np.asarray(ss, vals.dtype)).astype(vals.dtype),
                sign_scale=ss, e0=e0, e_min=e_min, theta=th,
                tt=3.0 if theta > 5 else 0.0,
                max_iter=RA.default_max_iter(n))


@functools.partial(jax.jit, static_argnames=("tiers", "max_phases"))
def _ref_tiered(cols, vals_t, valid, nvalid, p0, eps0, eps_min, theta,
                max_iter, trunc, theta_tail, wide_layout, init_state, *,
                tiers, max_phases):
    return RC.solve_ell_tiered(cols, vals_t, valid, nvalid, p0, eps0,
                               eps_min, theta, max_iter, tiers=tiers,
                               trunc=trunc, theta_tail=theta_tail,
                               wide_layout=wide_layout,
                               init_state=init_state, max_phases=max_phases)


def _ref(c, trunc=0, tiers=None, wide=False, max_phases=None,
         init_state=None):
    lay = None
    if wide:
        lay = build_wide_layout(
            c["cols"], c["vals"], c["valid"], c["n"],
            sign_scale=c["sign_scale"],
            neg=RA.neg_sentinel_np(c["vals"].dtype))
        assert lay is not None
    tiers = RC.default_tiers(c["n"]) if tiers is None else tiers
    dt = c["vals"].dtype
    return _ref_tiered(
        jnp.asarray(c["cols"]), jnp.asarray(c["vals_t"]),
        jnp.asarray(c["valid"]), jnp.asarray(c["nvalid"]),
        jnp.zeros(c["n"], dt), c["e0"], c["e_min"], c["theta"],
        c["max_iter"], jnp.int32(trunc),
        jnp.asarray(c["tt"], jnp.asarray(c["e0"]).dtype), lay, init_state,
        tiers=tiers, max_phases=max_phases)


def _port(c, trunc=0, tiers=None, wide=False, max_phases=None,
          init_state=None):
    return PC.solve_ell_tiered(
        _t(c["cols"]), _t(c["vals_t"]), _t(c["valid"]), _t(c["nvalid"]),
        torch.zeros(c["n"], dtype=PA.torch_dtype(c["vals"].dtype)),
        c["e0"], c["e_min"], c["theta"], c["max_iter"], tiers=tiers,
        trunc=trunc, theta_tail=c["tt"], wide=wide, max_phases=max_phases,
        init_state=init_state)


def _assert_same(ref, port):
    (r_res, r_st), (p_res, p_st) = ref, port
    np.testing.assert_array_equal(p_res.sigma.numpy(), np.asarray(r_res.sigma))
    np.testing.assert_array_equal(_bits(p_res.prices.numpy()),
                                  _bits(r_res.prices))
    np.testing.assert_array_equal(p_st.owner.numpy(), np.asarray(r_st.owner))
    assert p_res.rounds == int(r_res.rounds)
    assert p_res.phases == int(r_res.phases)
    assert p_res.unassigned == int(r_res.unassigned)
    assert _bits(p_res.final_eps) == _bits(r_res.final_eps)
    assert p_st.tier_rounds == np.asarray(r_st.tier_rounds).tolist()


@pytest.mark.parametrize("theta", [5.0, 10.0])
@pytest.mark.parametrize("trunc", [0, 16])
@pytest.mark.parametrize("integer", [True, False])
def test_solve_ell_tiered_matches_reference(integer, trunc, theta):
    """theta = 10 engages the mixed eps tail (theta_tail = 3)."""
    c = _case(0, 600, integer, theta=theta)
    ref = _ref(c, trunc=trunc)
    port = _port(c, trunc=trunc)
    _assert_same(ref, port)
    if trunc == 0:
        assert port[0].unassigned == 0
    else:
        assert 0 < port[0].unassigned <= trunc


@pytest.mark.parametrize("integer", [True, False])
def test_fine_ladder_with_floor_matches_reference(integer):
    c = _case(1, 700, integer)
    tiers = RC.default_tiers(700, fine=True, floor=16)
    assert PC.default_tiers(700, fine=True, floor=16) == tiers
    _assert_same(_ref(c, trunc=16, tiers=tiers),
                 _port(c, trunc=16, tiers=tiers))


@pytest.mark.parametrize("integer", [True, False])
def test_wide_loop_matches_reference_window_layout(integer):
    """The port's wide loop (full-width K1 rounds while > 2n/5 rows are
    active) against the reference run with its window-gather layout; the
    trajectory is the ladder's, only the round partition moves."""
    c = _case(2, 800, integer, contended=True)
    ref = _ref(c, trunc=16, wide=True)
    port = _port(c, trunc=16, wide=True)
    _assert_same(ref, port)
    res, st = port
    assert st.tier_rounds[0] > res.phases        # wide rounds ran
    plain_res, plain_st = _port(c, trunc=16)
    np.testing.assert_array_equal(plain_res.sigma.numpy(), res.sigma.numpy())
    np.testing.assert_array_equal(_bits(plain_res.prices.numpy()),
                                  _bits(res.prices.numpy()))
    assert plain_res.rounds == res.rounds
    assert plain_st.tier_rounds != st.tier_rounds


@pytest.mark.parametrize("integer", [True, False])
def test_resume_from_reference_state(integer):
    """max_phases stops at a phase boundary; the reference's TieredState
    carried across (TieredState.from_numpy) resumes the port exactly."""
    c = _case(3, 600, integer, theta=10.0)
    r_part = _ref(c, trunc=16, max_phases=2)
    p_part = _port(c, trunc=16, max_phases=2)
    _assert_same(r_part, p_part)
    assert p_part[0].phases == 3        # the first phase, then 2 more
    r_st = jax.device_get(r_part[1])
    st = PC.TieredState.from_numpy(r_st)
    _assert_same(_ref(c, trunc=16, init_state=r_part[1]),
                 _port(c, trunc=16, init_state=st))


def _mid_state(c, integer):
    res, st = _ref(c, trunc=16, max_phases=3)
    st = jax.device_get(st)
    dt = c["vals"].dtype
    vals_m = np.where(c["valid"], c["vals_t"], RA.neg_sentinel_np(dt))
    vt = c["vals_t"][c["valid"]]
    bigp = (vt.max() - vt.min()) + dt.type(1)
    return st, vals_m, bigp


@pytest.mark.parametrize("resolve_max", [8192, 0])   # all-pairs / scatter
@pytest.mark.parametrize("phase_start", [False, True])
@pytest.mark.parametrize("integer", [True, False])
def test_compact_round_matches_reference(integer, phase_start, resolve_max):
    c = _case(4, 500, integer, theta=10.0)
    n = c["n"]
    st, vals_m, bigp = _mid_state(c, integer)
    sigma, owner, prices = (np.asarray(st.sigma), np.asarray(st.owner),
                            np.asarray(st.prices))
    eps = np.asarray(st.eps)
    nvalid = c["nvalid"]
    if phase_start:
        eps = np.asarray(RA._next_eps(jnp.asarray(eps),
                                      jnp.asarray(c["theta"], eps.dtype),
                                      jnp.asarray(c["e_min"], eps.dtype)))
        ids = np.where(((sigma < 0) & (nvalid > 0)) | (sigma >= 0),
                       np.arange(n), n).astype(np.int32)
    else:
        live = np.flatnonzero((sigma < 0) & (nvalid > 0))
        assert live.size > 0
        ids = np.full(64, n, np.int32)
        ids[:live.size] = live
    rowpack = RC.build_rowpack(jnp.asarray(c["cols"]), jnp.asarray(vals_m),
                               jnp.asarray(nvalid))
    r = RC.compact_round(rowpack, jnp.asarray(prices), jnp.asarray(owner),
                         jnp.asarray(sigma), jnp.asarray(ids),
                         jnp.asarray(eps), jnp.asarray(bigp),
                         phase_start=phase_start,
                         pairs_resolve_max=resolve_max)
    p, o, s = _t(prices.copy()), _t(owner.copy()), _t(sigma.copy())
    new_ids, counts = PC.compact_round(
        _t(c["cols"]), _t(vals_m), _t(nvalid), p, o, s, _t(ids),
        eps[()], bigp, phase_start=phase_start)
    np.testing.assert_array_equal(_bits(p.numpy()), _bits(r[0]))
    np.testing.assert_array_equal(o.numpy(), np.asarray(r[1]))
    np.testing.assert_array_equal(s.numpy(), np.asarray(r[2]))
    np.testing.assert_array_equal(new_ids.numpy(), np.asarray(r[3]))
    assert counts.tolist()[:2] == [int(r[4]), int(r[5])]
    if phase_start:
        assert int(r[5]) >= 0 and (s.numpy() != sigma).any()


@pytest.mark.parametrize("n", [1, 2, 63, 64, 65, 100, 1000, 40_000,
                               100_000, 1_000_000])
def test_default_tiers_match_reference(n):
    for fine in (False, True):
        for floor in (0, 16, 256):
            assert PC.default_tiers(n, fine=fine, floor=floor) == \
                RC.default_tiers(n, fine=fine, floor=floor)


_next_eps_ref = jax.jit(RA._next_eps, static_argnames=("tail_phases",))


@pytest.mark.parametrize("tail_phases", [1, 2, 3])
@pytest.mark.parametrize("theta_tail", [0.0, 3.0, 2.5])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_next_eps_sequence_bitwise(dtype, theta_tail, tail_phases):
    if dtype == np.int32:
        eps, e_min, theta = dtype(50_000_000), dtype(1), dtype(10)
    else:
        eps, e_min, theta = (dtype(499.69553), dtype(0.000999001),
                             dtype(10.0))
    got, want = [], []
    e_p = eps
    e_r = jnp.asarray(eps)
    tt_r = jnp.asarray(theta_tail, jnp.asarray(eps.item()).dtype)
    while len(got) < 40:
        e_p = PA._next_eps(e_p, theta, e_min, theta_tail=theta_tail,
                           tail_phases=tail_phases)
        e_r = _next_eps_ref(e_r, jnp.asarray(theta), jnp.asarray(e_min),
                            theta_tail=tt_r, tail_phases=tail_phases)
        got.append(e_p)
        want.append(np.asarray(e_r))
        if e_p <= e_min:
            break
    assert got[-1] == e_min
    np.testing.assert_array_equal(_bits(np.array(got, dtype)),
                                  _bits(np.array(want, dtype)))


def test_wide_guard_matches_reference_layout():
    """The port engages its wide loop exactly where the reference's
    window layout is not refused by the skew guard."""
    rng = np.random.default_rng(5)
    n, K, m = 3000, 6, 3000
    cols = rng.integers(0, m, (n, K)).astype(np.int32)
    valid = rng.random((n, K)) < 0.9
    vals = rng.random((n, K)).astype(np.float32)
    neg = RA.neg_sentinel_np(np.float32)
    skewed = cols % 128                    # every entry in window 0
    for cc in (cols, skewed):
        ref = build_wide_layout(cc, vals, valid, m, sign_scale=-1, neg=neg)
        assert PH._wide_layout_ok(cc, valid, m) == (ref is not None)
    assert PH._wide_layout_ok(cols, valid, m)
    assert not PH._wide_layout_ok(skewed, valid, m)
