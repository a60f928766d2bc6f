"""The port's ingest, config and feasibility layers against the JAX
package's: identical ELL arrays (bit for bit), dtype rules, validation and
matchings, for dense, COO and CSR inputs."""

import numpy as np
import pytest

from sslap_tpu import config as RCfg
from sslap_tpu import feasibility as RF
from sslap_tpu import ingest as RI
from sslap_tpu_torch import config as PCfg
from sslap_tpu_torch import feasibility as PF
from sslap_tpu_torch import ingest as PI
from tests.utils import random_sparse_instance


def _assert_same(r, p):
    for f in ("cols", "vals", "valid", "nvalid"):
        a, b = np.asarray(getattr(r, f)), getattr(p, f)
        assert isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert (r.n, r.m, r.K, r.nnz, r.int_exact) == \
        (p.n, p.m, p.K, p.nnz, p.int_exact)


def _coo(kind, rng):
    n, m = 40, 55
    loc, val, _ = random_sparse_instance(rng, n, m, 0.2,
                                         integer=kind != "float")
    if kind == "float32":
        val = val.astype(np.float32)
    elif kind == "int_exact":
        val = val * 10 ** 6          # too large for the int32 path
    return loc, val, (n, m)


@pytest.mark.parametrize("pad_to", [None, 30])
@pytest.mark.parametrize("kind", ["int", "float", "float32", "int_exact"])
def test_from_coo_matches_reference(kind, pad_to):
    rng = np.random.default_rng(0)
    loc, val, shape = _coo(kind, rng)
    r = RI.from_coo(loc, val, shape=shape, pad_to=pad_to)
    p = PI.from_coo(loc, val, shape=shape, pad_to=pad_to)
    _assert_same(r, p)
    assert p.int_exact == (kind == "int_exact")
    assert p.vals.dtype == {"int": np.int32, "float": np.float32,
                            "float32": np.float32,
                            "int_exact": np.float64}[kind]
    # inferred shape, and an explicit solver dtype
    _assert_same(RI.from_coo(loc, val), PI.from_coo(loc, val))
    _assert_same(RI.from_coo(loc, val, shape=shape, dtype=np.float64),
                 PI.from_coo(loc, val, shape=shape, dtype=np.float64))


@pytest.mark.parametrize("kind", ["int", "float", "float32"])
def test_from_dense_with_forbidden_entries_matches_reference(kind):
    rng = np.random.default_rng(1)
    _, _, dense = random_sparse_instance(rng, 30, 45, 0.3,
                                         integer=kind == "int")
    if kind != "int":
        dense[3, :5] = np.nan                 # NaN = forbidden too
        dense = dense.astype(np.float32 if kind == "float32" else np.float64)
    r = RI.from_dense(dense)
    p = PI.from_dense(dense)
    _assert_same(r, p)
    assert p.nnz == int(((dense >= 0) & np.isfinite(dense)).sum())


def test_from_csr_and_empty_rows_match_reference():
    rng = np.random.default_rng(2)
    loc, val, shape = _coo("int", rng)
    keep = loc[:, 0] != 7                     # row 7 has no entries
    loc, val = loc[keep], val[keep]
    order = np.lexsort((loc[:, 1], loc[:, 0]))
    loc, val = loc[order], val[order]
    indptr = np.zeros(shape[0] + 1, np.int64)
    np.cumsum(np.bincount(loc[:, 0], minlength=shape[0]), out=indptr[1:])
    r = RI.from_csr(indptr, loc[:, 1], val, shape=shape)
    p = PI.from_csr(indptr, loc[:, 1], val, shape=shape)
    _assert_same(r, p)
    assert p.nvalid[7] == 0
    empty = (np.zeros((0, 2), np.int64), np.zeros(0, np.int32))
    _assert_same(RI.from_coo(*empty, shape=(3, 4)),
                 PI.from_coo(*empty, shape=(3, 4)))


def test_from_reference_round_trip():
    rng = np.random.default_rng(3)
    loc, val, shape = _coo("float32", rng)
    r = RI.from_coo(loc, val, shape=shape)
    p = PI.from_reference(r)
    _assert_same(r, p)
    assert p == PI.from_reference(p)         # any object with the fields
    _assert_same(RI.from_coo(loc, val * 10 ** 6, shape=shape),
                 PI.from_reference(RI.from_coo(loc, val * 10 ** 6,
                                               shape=shape)))


@pytest.mark.parametrize("vals,dtype,m", [
    (np.array([1, 2, 3]), None, 10),
    (np.array([1, 2, 3]), None, 2 ** 25),
    (np.array([True, False]), None, 4),
    (np.array([1.5, 2.0]), None, 4),
    (np.array([1, 2]), np.float64, 4),
    (np.array([1.0, 2.0]), np.float64, 4),
    (np.array([1, 2]), np.float32, 4),
])
def test_solver_dtype_matches_reference(vals, dtype, m):
    assert PI._solver_dtype(vals, dtype, m=m) == \
        RI._solver_dtype(vals, dtype, m=m)


@pytest.mark.parametrize("call", [
    lambda M: M.from_coo(np.array([[0, 0], [0, 0]]), np.array([1, 2])),
    lambda M: M.from_coo(np.array([[0, -1]]), np.array([1])),
    lambda M: M.from_coo(np.array([[0, 0]]), np.array([-1.0])),
    lambda M: M.from_coo(np.array([[0, 0]]), np.array([np.inf])),
    lambda M: M.from_coo(np.array([[3, 0]]), np.array([1]), shape=(2, 2)),
    lambda M: M.from_coo(np.array([[1, 0]]), np.array([1])),    # n > m
    lambda M: M.from_coo(np.array([[0.0, 0.0]]), np.array([1])),
    lambda M: M.from_coo(np.array([[0, 0]]), np.array([2 ** 60])),
    lambda M: M.from_dense(np.ones((3, 2))),
    lambda M: M.from_dense(np.ones(3)),
])
def test_ingest_rejects_like_reference(call):
    with pytest.raises(ValueError):
        call(RI)
    with pytest.raises(ValueError):
        call(PI)


def test_config_matches_reference():
    assert PCfg.AuctionConfig().solver_kwargs() == \
        RCfg.AuctionConfig().solver_kwargs()
    kw = dict(problem="max", theta=7.0, theta_tail=3.0, tail_phases=3,
              mode="cpu", engine="compact", gs_engine="fr", wide_rounds=True)
    assert PCfg.AuctionConfig(**kw).solver_kwargs() == \
        RCfg.AuctionConfig(**kw).solver_kwargs()
    for bad in (dict(problem="x"), dict(theta=1.0), dict(theta_tail=0.5),
                dict(tail_phases=0), dict(mode="x"), dict(engine="x"),
                dict(gs_engine="x")):
        with pytest.raises(ValueError):
            RCfg.AuctionConfig(**bad)
        with pytest.raises(ValueError):
            PCfg.AuctionConfig(**bad)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_hopcroft_karp_matches_reference(seed, use_native):
    rng = np.random.default_rng(seed)
    n, m = 60, 70
    loc, val, _ = random_sparse_instance(rng, n, m, 0.05)
    drop = rng.random(loc.shape[0]) < 0.3     # break the planted matching
    loc, val = loc[~drop], val[~drop]
    r = RI.from_coo(loc, val, shape=(n, m))
    p = PI.from_reference(r)
    mr, mc, size = RF.hopcroft_karp(r, use_native=use_native)
    pr, pc, psize = PF.hopcroft_karp(p, use_native=use_native)
    np.testing.assert_array_equal(pr, mr)
    np.testing.assert_array_equal(pc, mc)
    assert psize == size
    assert PF.is_feasible(p, use_native=use_native) == \
        RF.is_feasible(r, use_native=use_native)
    warm = np.where(rng.random(n) < 0.5, rng.integers(-1, m, n), -1)
    for a, b in zip(RF.sanitize_matching(r, warm),
                    PF.sanitize_matching(p, warm)):
        np.testing.assert_array_equal(a, b)
    init = PF.sanitize_matching(p, warm)
    for a, b in zip(RF.hopcroft_karp(r, use_native=use_native,
                                     init_match=init),
                    PF.hopcroft_karp(p, use_native=use_native,
                                     init_match=init)):
        np.testing.assert_array_equal(a, b)
