"""The port's device seed of the Hopcroft-Karp check
(sslap_tpu_torch.feasibility_device, and ``device_seed=`` on
feasibility.hopcroft_karp / is_feasible) against the JAX package's, on the
CPU (``device="cpu"``).

Tolerance: exact.  The packed column tables, the greedy matchings, the
warm-started HK matchings and sizes are equal; sizes equal scipy's.
"""

import numpy as np
import pytest
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import maximum_bipartite_matching

from sslap_tpu import feasibility as RF
from sslap_tpu import feasibility_device as RFD
from sslap_tpu import ingest as RI
from sslap_tpu_torch import feasibility as PF
from sslap_tpu_torch import feasibility_device as PFD
from sslap_tpu_torch import ingest as PI


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
