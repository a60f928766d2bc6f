"""The benchmark's generator copies against their sources, and the
stationary drift pool of the tracking traffic."""

import numpy as np
import pytest

from lapbench import gen


@pytest.mark.parametrize("n,m,k,seed", [(50, 50, 9, 0), (64, 80, 3, 2**40)])
def test_make_instance_equals_the_tracking_harness(n, m, k, seed):
    from sslap_tpu_torch.benchmarks.tracking import make_instance
    for a, b in zip(gen.make_instance(n, m, k, seed),
                    make_instance(n, m, k, seed)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("integer", [False, True])
def test_make_sparse_equals_chip_smoke(integer):
    import chip_smoke
    a = gen.make_sparse(40, 48, 6, seed=7, integer=integer)
    b = chip_smoke.make_sparse(40, 48, 6, seed=7, integer=integer)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_drift_values_equals_the_tracking_harness():
    from sslap_tpu_torch.benchmarks.tracking import drift_values
    v = np.linspace(1, 999, 1000).astype(np.float32)
    a = gen.drift_values(v, np.random.default_rng(3), 10.0)
    b = drift_values(v, np.random.default_rng(3), 10.0)
    assert np.array_equal(a, b)


def test_drift_pool_neighbours_differ_by_sigma():
    """Consecutive arrays, the wrap from the last to the first included,
    differ by sigma = 10 (values far from the clip, so nothing clips)."""
    v = np.full(400_000, 500.0, np.float32)
    pool = gen.drift_pool(v, np.random.default_rng(11), 4, sigma=10.0)
    for j in range(4):
        d = pool[(j + 1) % 4].astype(np.float64) - pool[j]
        assert abs(d.std() - 10.0) < 0.05
        assert abs(d.mean()) < 0.05


def test_drift_pool_clips_to_the_cost_range():
    v = np.array([1.0, 999.9], np.float32).repeat(1000)
    for a in gen.drift_pool(v, np.random.default_rng(1), 4, sigma=10.0):
        assert a.min() >= 1.0 and a.max() <= 1000.0


def test_seed_streams_take_large_seeds():
    big = 2 ** 31 + 12345
    a = gen.seed_int(big, 0, 1)
    assert a == gen.seed_int(big, 0, 1) and a != gen.seed_int(big, 0, 2)
    assert 0 <= a < 2 ** 63
