"""The port's device seed of the Hopcroft-Karp check
(sslap_tpu_torch.feasibility_device, and ``device_seed=`` on
feasibility.hopcroft_karp / is_feasible) against the JAX package's, on the
CPU (``device="cpu"``).

Tolerance: exact.  The packed column tables, the greedy matchings, the
warm-started HK matchings and sizes are equal; sizes equal scipy's.  The
pre-check's size-only matcher (native Pothen-Fan+, ``is_feasible``'s
path) gives HK's and scipy's size, cold and warm, and leaves the solve's
answer unchanged.
"""

import numpy as np
import pytest
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import maximum_bipartite_matching

from sslap_tpu import feasibility as RF
from sslap_tpu import feasibility_device as RFD
from sslap_tpu import ingest as RI
from sslap_tpu_torch import _native
from sslap_tpu_torch import feasibility as PF
from sslap_tpu_torch import feasibility_device as PFD
from sslap_tpu_torch import ingest as PI
from sslap_tpu_torch.utils import profiling as prof


def _rand_prob(rng, n, m, density):
    """tests/test_feasibility.py's instances: a dense mask, forbidden -1."""
    mask = rng.random((n, m)) < density
    mat = np.where(mask, rng.integers(1, 100, (n, m)), -1).astype(float)
    r = RI.from_dense(mat)
    return r, PI.from_reference(r), mask


def _sparse_prob(rng, n, m, k):
    """k random columns a row (some rows lose all of them), no planted
    matching: a real residual for HK to augment."""
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, m, n * k)
    keep = rng.random(n * k) < 0.9
    key = np.unique(rows[keep] * m + cols[keep])
    loc = np.stack([key // m, key % m], 1)
    r = RI.from_coo(loc, rng.integers(1, 100, len(key)), shape=(n, m))
    mask = csr_matrix((np.ones(len(key)), (loc[:, 0], loc[:, 1])),
                      shape=(n, m))
    return r, PI.from_reference(r), mask


def _scipy_size(mask) -> int:
    return int((maximum_bipartite_matching(csr_matrix(mask),
                                           perm_type="column") >= 0).sum())


CASES = ([("dense", s, 80, 90, 0.1) for s in range(4)]
         + [("dense", 100 + s, 70, 70, d) for s in range(4)
            for d in (0.03, 0.15)]
         + [("dense", 7, 40, 44, 0.12), ("sparse", 9, 5000, 5200, 3),
            ("sparse", 10, 4500, 4500, 2)])


def _case(kind, seed, n, m, arg):
    rng = np.random.default_rng(seed)
    if kind == "dense":
        return _rand_prob(rng, n, m, arg)
    return _sparse_prob(rng, n, m, arg)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_greedy_matching_matches_reference(case):
    """Bit for bit, on the reference's own test instances and on n > 4096
    (the reference's tier ladder cuts from n to 4096 and 512 active ids)."""
    r, p, _ = _case(*case)
    want = RFD.greedy_matching(r)
    got = PFD.greedy_matching(p, device="cpu")
    for a, b in zip(got, want):
        assert a.dtype == np.int64 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert PFD.greedy_matching_packed.rounds >= 1
    rows = np.flatnonzero(got[0] >= 0)
    assert (got[1][got[0][rows]] == rows).all()


@pytest.mark.parametrize("K", [1, 8, 10, 200])
def test_build_colpack_matches_reference(K):
    rng = np.random.default_rng(K)
    n, m = 37, 300
    cols = np.sort(rng.choice(m, (n, K)), axis=1).astype(np.int32)
    valid = rng.random((n, K)) < 0.7
    want, wr = RFD.build_colpack(cols, valid, m)
    got, gr = PFD.build_colpack(cols, valid, m)
    assert gr == wr and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes() and got.shape == want.shape
    # a line is R contiguous rows: the flat view is the row table
    flat = torch.from_numpy(got).view(-1, K)[:n].numpy()
    np.testing.assert_array_equal(flat, np.where(valid, cols, m))


# the pure-Python HK (use_native=False) on the small instances only
HK_CASES = ([(c, True) for c in CASES[4:9] + CASES[-2:]]
            + [(c, False) for c in CASES[4:9]])


@pytest.mark.parametrize("case,use_native", HK_CASES,
                         ids=lambda c: "-".join(map(str, c))
                         if isinstance(c, tuple) else f"native={c}")
def test_seeded_hopcroft_karp_matches_reference(case, use_native):
    r, p, mask = _case(*case)
    size = _scipy_size(mask)
    for seed in (False, True):
        want = RF.hopcroft_karp(r, use_native=use_native, device_seed=seed)
        got = PF.hopcroft_karp(p, use_native=use_native, device_seed=seed,
                               device="cpu")
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(a, b)
        assert got[2] == want[2] == size
        assert PF.is_feasible(p, use_native=use_native, device_seed=seed,
                              device="cpu") == \
            RF.is_feasible(r, use_native=use_native, device_seed=seed) == \
            (size == p.n)
    init = PFD.greedy_matching(p, device="cpu")    # init_match wins
    got = PF.hopcroft_karp(p, use_native=use_native, device_seed=False,
                           init_match=init, device="cpu")
    want = RF.hopcroft_karp(r, use_native=use_native, init_match=init)
    np.testing.assert_array_equal(got[0], want[0])


def test_a_failing_device_seed_raises(monkeypatch):
    """No fallback to the host seed: the device pass's error reaches the
    caller (the reference swallows it and runs host HK)."""
    r, p, _ = _case(*CASES[0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PF.hopcroft_karp(p, device_seed=True)
        with pytest.raises(RuntimeError, match="CUDA"):
            PF.is_feasible(p, device_seed=True, device="cuda")

    def broken(prob, device="cuda"):
        raise MemoryError("device pass failed")

    monkeypatch.setattr(PFD, "greedy_matching", broken)
    with pytest.raises(MemoryError):
        PF.hopcroft_karp(p, device_seed=True, device="cpu")
    # the default (None) and False stay on the host and never reach it
    assert PF.hopcroft_karp(p, device="cpu")[2] == \
        PF.hopcroft_karp(p, device_seed=False)[2] == RF.hopcroft_karp(r)[2]


# --- the pre-check's size-only matcher (native Pothen-Fan+) ---------------


def _pf_size(p, init_match=None):
    indptr, indices = PF._ell_to_csr(p)
    return _native.max_matching_size_native_i32(indptr, indices, p.n, p.m,
                                                init_match=init_match)


def _coo_prob(n, m, rows, cols):
    """The pattern (rows, cols) as an ELLProblem, with its scipy mask; a
    row with no entry gets none."""
    key = np.unique(np.asarray(rows, np.int64) * m + np.asarray(cols))
    loc = np.stack([key // m, key % m], 1)
    p = PI.from_coo(loc, np.ones(len(key)), shape=(n, m))
    mask = csr_matrix((np.ones(len(key)), (loc[:, 0], loc[:, 1])),
                      shape=(n, m))
    return p, mask


def _check_sizes(p, mask):
    """The matcher's size equals the native and the pure-Python HK's and
    scipy's; is_feasible is (scipy size == n) on every path."""
    size = _scipy_size(mask)
    got, passes, augmented = _pf_size(p)
    assert got == size
    assert PF.hopcroft_karp(p)[2] == size
    assert PF.hopcroft_karp(p, use_native=False)[2] == size
    assert 0 <= augmented <= size and passes >= (augmented > 0)
    want = size == p.n
    assert PF.is_feasible(p) == want
    assert PF.is_feasible(p, use_native=False) == want
    return got, passes, augmented


def test_the_native_size_matcher_is_loaded():
    assert _native.native_available()
    assert _native.max_matching_size_native_i32 is not None


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_size_matcher_equals_hopcroft_karp(case):
    _, p, mask = _case(*case)
    _check_sizes(p, mask)


# (seed, n, m, entries a row, share of rows emptied)
RANDOM = [(1, 1, 1, 1, 0.0), (2, 1, 7, 3, 0.0), (3, 1, 5, 2, 1.0),
          (4, 9, 1, 1, 0.0), (5, 2000, 1500, 3, 0.0),
          (6, 1500, 2000, 2, 0.05), (7, 5000, 5000, 3, 0.0),
          (8, 5000, 5000, 1, 0.0), (9, 4000, 4000, 2, 0.01),
          (10, 3000, 6000, 2, 0.0), (11, 5000, 4999, 4, 0.0)]


@pytest.mark.parametrize("seed,n,m,k,empty", RANDOM)
def test_size_matcher_on_random_patterns(seed, n, m, k, empty):
    """Feasible and infeasible patterns, rows with no entries, n < m,
    n > m, n = 1; a planted permutation makes the square ones feasible.
    An ELLProblem takes n <= m, so n > m is checked on the CSR alone."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, m, n * k)
    if n == m and k > 1:
        rows = np.concatenate([rows, np.arange(n)])
        cols = np.concatenate([cols, rng.permutation(m)])
    drop = rng.random(n) < empty
    keep = ~drop[rows]
    if n > m:
        key = np.unique(rows[keep] * m + cols[keep])
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(key // m, minlength=n), out=indptr[1:])
        indices = (key % m).astype(np.int32)
        size = _scipy_size(csr_matrix(
            (np.ones(len(key)), indices, indptr), shape=(n, m)))
        assert size <= m < n
        got, _, _ = _native.max_matching_size_native_i32(indptr, indices,
                                                         n, m)
        assert got == size
        for use_native in (True, False):
            assert PF.hopcroft_karp_csr(indptr, indices, n, m,
                                        use_native=use_native)[2] == size
        return
    p, mask = _coo_prob(n, m, rows[keep], cols[keep])
    got, _, _ = _check_sizes(p, mask)
    if drop.any():
        assert not PF.is_feasible(p)
    if n == m and k > 1 and not drop.any():
        assert got == n and PF.is_feasible(p)


def _chains(lengths, extra_row=False):
    """Chains that the greedy seed leaves one row short each, and whose
    one augmenting path is 2 L + 1 edges long: rows i < L of a chain take
    columns {i, i + 1}, row L column 0 alone (the greedy seed matches row
    i to column i, so row L finds column 0 taken).  ``extra_row`` adds a
    row on the first chain's column 0 and a column on no row: one row
    more than can be matched."""
    rows, cols, r0, c0 = [], [], 0, 0
    for L in lengths:
        for i in range(L):
            rows += [r0 + i, r0 + i]
            cols += [c0 + i, c0 + i + 1]
        rows.append(r0 + L)
        cols.append(c0)
        r0, c0 = r0 + L + 1, c0 + L + 1
    if extra_row:
        rows.append(r0)
        cols.append(0)
        r0, c0 = r0 + 1, c0 + 1
    return r0, c0, rows, cols


@pytest.mark.parametrize("lengths,extra_row",
                         [([25], False), ([11, 40, 64], False),
                          ([21] * 200, False), ([30] * 120, True)])
def test_size_matcher_augments_long_paths(lengths, extra_row):
    n, m, rows, cols = _chains(lengths, extra_row)
    p, mask = _coo_prob(n, m, rows, cols)
    got, passes, augmented = _check_sizes(p, mask)
    assert got == n - extra_row
    assert augmented == len(lengths)                # one path a chain
    assert passes >= 1
    assert PF.is_feasible(p) == (not extra_row)


@pytest.mark.parametrize("case", CASES[4:9] + CASES[-2:],
                         ids=lambda c: "-".join(map(str, c)))
def test_size_matcher_warm_starts(case):
    """From the device greedy matching, and from a stale matching (another
    pattern's HK matching) passed through ``sanitize_matching``."""
    kind, seed, n, m, arg = case
    _, p, mask = _case(*case)
    size = _scipy_size(mask)
    init = PFD.greedy_matching(p, device="cpu")
    seeded = int((init[0] >= 0).sum())
    got, _, augmented = _pf_size(p, init_match=init)
    assert got == size and augmented == size - seeded
    assert PF.is_feasible(p, device_seed=True, device="cpu") == \
        (size == p.n)
    _, other, _ = _case(kind, seed + 1000, n, m, arg)
    stale = PF.hopcroft_karp(other)[0]
    warm = PF.sanitize_matching(p, stale)
    got, _, augmented = _pf_size(p, init_match=warm)
    assert got == size and augmented == size - int((warm[0] >= 0).sum())


def test_warm_start_leaves_the_given_matching_as_it_was():
    _, p, _ = _case(*CASES[-1])
    init = PFD.greedy_matching(p, device="cpu")
    before = [a.copy() for a in init]
    _pf_size(p, init_match=init)
    for a, b in zip(init, before):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("how", ["threshold", "no_native", "use_native"])
def test_is_feasible_falls_back_to_hopcroft_karp(monkeypatch, how):
    """At 2**31 rows or columns (reached by lowering the threshold), with
    no native library, or with use_native=False, is_feasible runs HK and
    never the size matcher."""
    n, m, rows, cols = _chains([15, 22, 40])
    p, mask = _coo_prob(n, m, rows, cols)
    want = _scipy_size(mask) == p.n
    assert want

    def stub(*a, **kw):
        raise AssertionError("the size matcher ran")

    ran = []
    real_hk = PF.hopcroft_karp
    real_size = _native.max_matching_size_native_i32

    def spy(*a, **kw):
        ran.append(kw)
        return real_hk(*a, **kw)

    monkeypatch.setattr(PF, "hopcroft_karp", spy)
    kw = {}
    if how == "threshold":
        monkeypatch.setattr(_native, "max_matching_size_native_i32", stub)
        monkeypatch.setattr(PF, "_SIZE_NATIVE_MAX", max(p.n, p.m))
    elif how == "no_native":
        monkeypatch.setattr(_native, "max_matching_size_native_i32", None)
    else:
        monkeypatch.setattr(_native, "max_matching_size_native_i32", stub)
        kw = {"use_native": False}
    with prof.span("hk") as sp:
        assert PF.is_feasible(p, **kw) == want
    assert len(ran) == 1 and sp.counts == {}
    # one row or column fewer than the threshold takes the size matcher
    if how == "threshold":
        monkeypatch.setattr(_native, "max_matching_size_native_i32",
                            real_size)
        monkeypatch.setattr(PF, "_SIZE_NATIVE_MAX", max(p.n, p.m) + 1)
        assert PF.is_feasible(p) == want and len(ran) == 1


def test_is_feasible_counts_on_the_hk_span():
    n, m, rows, cols = _chains([15, 22])
    p, _ = _coo_prob(n, m, rows, cols)
    with prof.span("hk") as sp:
        assert PF.is_feasible(p)
    assert sp.counts["augmented"] == 2 and sp.counts["passes"] >= 1
    assert set(sp.counts) == {"passes", "augmented"}
    with prof.span("other") as other:               # only on an hk span
        assert PF.is_feasible(p)
    assert other.counts == {}
    assert PF.is_feasible(p)                        # no span open


def test_hopcroft_solve_still_matches_reference_with_the_matcher_loaded():
    import sslap_tpu as R
    import sslap_tpu_torch as P
    assert _native.max_matching_size_native_i32 is not None
    rng = np.random.default_rng(23)
    for n, m in ((300, 300), (200, 260)):
        loc = np.unique(np.stack([rng.integers(0, n, 4 * n),
                                  rng.integers(0, m, 4 * n)], 1), axis=0)
        np.testing.assert_array_equal(
            P.hopcroft_solve(loc=loc, shape=(n, m)),
            R.hopcroft_solve(loc=loc, shape=(n, m)))


@pytest.mark.parametrize("mode", [None, "hybrid"])
def test_a_cold_solve_is_bit_identical_with_the_size_matcher(monkeypatch,
                                                             mode):
    """200k rows: the same sol, prices and objective with the pre-check on
    the size matcher and on HK (the check reads only the bool)."""
    import sslap_tpu_torch as P
    n, k = 200_000, 9
    rng = np.random.default_rng(5)
    rows = np.concatenate([np.repeat(np.arange(n), k), np.arange(n)])
    cols = np.concatenate([rng.integers(0, n, n * k), rng.permutation(n)])
    key = np.unique(rows * n + cols)
    loc = np.stack([key // n, key % n], 1)
    val = rng.uniform(1, 1000, len(key)).astype(np.float32)
    kw = {} if mode is None else {"mode": mode}

    def solve():
        return P.AuctionSolver(loc=loc, val=val, shape=(n, n),
                               device="cpu", **kw).solve()

    calls = []
    real = _native.max_matching_size_native_i32

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(_native, "max_matching_size_native_i32", counted)
    after = solve()
    assert calls == [1]
    monkeypatch.setattr(PF, "is_feasible",
                        lambda prob, **k: PF.hopcroft_karp(prob)[2] == prob.n)
    before = solve()
    assert calls == [1]
    assert after["meta"]["soln_found"] and before["meta"]["soln_found"]
    np.testing.assert_array_equal(after["sol"], before["sol"])
    assert np.asarray(after["prices"]).tobytes() == \
        np.asarray(before["prices"]).tobytes()
    assert after["meta"]["obj"] == before["meta"]["obj"]


def test_size_matcher_rejects_short_arrays():
    _, p, _ = _case(*CASES[4])
    indptr, indices = PF._ell_to_csr(p)
    with pytest.raises(ValueError, match="CSR"):
        _native.max_matching_size_native_i32(indptr[:-1], indices, p.n, p.m)
    with pytest.raises(ValueError, match="CSR"):
        _native.max_matching_size_native_i32(indptr, indices[:-1], p.n, p.m)
    init = PFD.greedy_matching(p, device="cpu")
    with pytest.raises(ValueError, match="init_match"):
        _native.max_matching_size_native_i32(indptr, indices, p.n, p.m,
                                             init_match=(init[0][:-1],
                                                         init[1]))
