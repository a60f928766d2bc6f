"""Input generators of the benchmark, drawn from ``--seed``.

``make_instance`` and ``drift_values`` are copies of
``sslap_tpu_torch/benchmarks/tracking.py`` (itself bench.py's generator),
``make_sparse`` of ``chip_smoke.py`` (benchmarks/run_all.py's), so that
the program can change its own copies without moving the yardstick.
``tests/test_lapbench_gen.py`` holds each copy equal to its source.
"""

from __future__ import annotations

import numpy as np


def make_instance(n, m, k_extra, seed=0, low=1.0, high=1000.0):
    """k_extra random columns per row plus a planted permutation, float32
    costs in [low, high); COO sorted by (row, col), no duplicates."""
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


def make_sparse(n, m, nnz_per_row, seed=0, high=1000, integer=True):
    """nnz_per_row - 1 random columns per row plus a planted matching,
    deduplicated by the sorted fused key; integer costs in [1, high), or
    float32 in [1, high).  Returns (loc [nnz, 2] int64, val)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), nnz_per_row - 1)
    cols = rng.integers(0, m, rows.shape[0], dtype=np.int64)
    perm = rng.permutation(m)[:n].astype(np.int64)
    key = np.concatenate([rows * m + cols,
                          np.arange(n, dtype=np.int64) * m + perm])
    key.sort()
    keep = np.empty(key.shape[0], bool)
    keep[0] = True
    np.not_equal(key[1:], key[:-1], out=keep[1:])
    key = key[keep]
    loc = np.stack([key // m, key % m], 1)
    if integer:
        return loc, rng.integers(1, high, loc.shape[0])
    return loc, (rng.random(loc.shape[0]) * (high - 1) + 1).astype(np.float32)


def drift_values(val, rng, sigma=10.0, low=1.0, high=1000.0):
    """One step of the tracking harness's value drift: a clipped
    Gaussian of standard deviation ``sigma`` on every entry."""
    return np.clip(val + rng.standard_normal(val.shape).astype(np.float32)
                   * np.float32(sigma), low, high).astype(np.float32)


def drift_pool(val, rng, frames, sigma=10.0, low=1.0, high=1000.0):
    """``frames`` value arrays ``clip(val + sigma / sqrt(2) * z_j)`` over one
    pattern.  Any two of them, consecutive ones and the wrap from the last
    to the first included, differ by a clipped Gaussian of standard
    deviation ``sigma``: a stationary stand-in for the drift walk, which
    cannot be made ahead for a window of open length."""
    s = sigma / np.sqrt(2.0)
    return [drift_values(val, rng, s, low, high) for _ in range(frames)]


def seed_rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of a run's seed (any whole number >= 0,
    also past 2**32)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), *stream]))


def seed_int(seed: int, *stream: int) -> int:
    """A 63-bit seed for a source generator that takes an int."""
    return int(seed_rng(seed, *stream).integers(0, 2 ** 63 - 1))
