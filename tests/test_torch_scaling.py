"""The port's round-breakdown harness (sslap_tpu_torch.parallel.scaling)
against the JAX package's (sslap_tpu.parallel.scaling), on the CPU: the
same keys, times that are finite and non-negative (CPU seconds: they say
nothing of a device), the shard count, and the nnz imbalance of the row
partition equal to the reference's (exact); and ``instrument=True`` on the
sharded and the overlapped solve.
"""

import jax
import numpy as np
import pytest
import torch

from sslap_tpu import ingest as RI
from sslap_tpu import parallel as RP
from sslap_tpu.parallel import scaling as RS
from sslap_tpu_torch import ingest as PI
from sslap_tpu_torch import parallel as PP
from tests.utils import random_sparse_instance

CPU = torch.device("cpu")
TIMES = ("round_s", "compute_s", "comm_s", "comm_fraction")


def _problem(n=36, m=36, seed=3):
    rng = np.random.default_rng(seed)
    loc, val, _ = random_sparse_instance(rng, n, m, 0.2)
    return loc, val, RI.from_coo(loc, val, shape=(n, m))


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("shards,partition", [(1, "rows"), (2, "nnz"),
                                              (4, "rows"), (4, "nnz")])
def test_round_breakdown_matches_reference(shards, partition, overlap):
    _, _, ref_prob = _problem(n=30, m=30 if overlap else 37)
    kw = dict(partition=partition, overlap=overlap)
    ref = RS.measure_round_breakdown(
        ref_prob, RP.make_mesh(devices=jax.devices()[:shards]), **kw)
    got = PP.measure_round_breakdown(
        PI.from_reference(ref_prob), PP.make_mesh([CPU] * shards), **kw)
    assert set(got) == set(ref)
    for k in TIMES:
        assert np.isfinite(got[k]) and got[k] >= 0, k
    assert got["round_s"] > 0 and got["compute_s"] > 0
    assert got["comm_s"] == max(got["round_s"] - got["compute_s"], 0.0)
    assert got["comm_fraction"] <= 1
    assert got["n_shards"] == ref["n_shards"] == shards
    assert got["nnz_imbalance"] == ref["nnz_imbalance"]


@pytest.mark.parametrize("backend", ["sharded", "overlapped"])
def test_instrument_adds_the_breakdown(backend):
    """instrument=True on both solves: the solution is the plain call's,
    and the meta gains the breakdown's keys, as the reference's does."""
    loc, val, _ = _problem()
    fn = {"sharded": (RP.auction_solve_sharded, PP.auction_solve_sharded),
          "overlapped": (RP.auction_solve_overlapped,
                         PP.auction_solve_overlapped)}[backend]
    kw = dict(loc=loc, val=val, shape=(36, 36))
    ref = fn[0](mesh=RP.make_mesh(devices=jax.devices()[:2]),
                instrument=True, **kw)
    mesh = PP.make_mesh([CPU] * 2)
    plain = fn[1](mesh=mesh, **kw)
    got = fn[1](mesh=mesh, instrument=True, **kw)
    np.testing.assert_array_equal(got["sol"], plain["sol"])
    np.testing.assert_array_equal(got["sol"], ref["sol"])
    assert set(got["meta"]) == set(ref["meta"])
    assert set(got["meta"]) - set(plain["meta"]) == set(TIMES) | {
        "nnz_imbalance"}
    for k in TIMES:
        assert np.isfinite(got["meta"][k]) and got["meta"][k] >= 0, k
    assert got["meta"]["nnz_imbalance"] == ref["meta"]["nnz_imbalance"]
