"""K3's plain twin (sslap_tpu_torch.ops.gs_auction_plain, what
``gs_auction_device`` runs on CPU tensors) against the JAX package's Pallas
kernel in interpret mode and the native C++ ``auction_gs``, on the CPU.

Tolerance: exact -- owner, bid count and rows left equal, prices bit for
bit: every f32 op (w = (a+0) - (p+0), bid = (a* - v2) + eps) is the same op
in the same order on all three.  The kernel itself runs only on a CUDA
device (test_torch_cuda.py).

The Pallas kernel reads a slot as padding when ``vals <= -bigp``, which
also drops real entries of min problems whose costs are all >= 1; its
instances here keep every real entry above -bigp, and
``test_twin_reads_real_entries_the_native_engine_reads`` holds the port to
the native engine where the Pallas kernel's rule would not.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sslap_tpu import hybrid as RH
from sslap_tpu import ingest as RI
from sslap_tpu.native import auction_gs as native_gs
from sslap_tpu.ops.gs_kernel import gs_auction_device as pallas_gs
from sslap_tpu_torch.auction import neg_sentinel_np
from sslap_tpu_torch.ops import gs_auction_device, gs_auction_plain
from tests.utils import random_sparse_instance

pytestmark = pytest.mark.skipif(not RH.native_available(),
                                reason="native toolchain unavailable")


def _bits(a):
    return np.asarray(a).view(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _instance(kind):
    """(ELLProblem, eps): the two instances of the JAX package's own K3
    tests, one with zero costs, and one whose costs are all >= 5."""
    if kind == "single_entry_rows":
        rng = np.random.default_rng(9)
        n = 24
        locs = [(i, i) for i in range(8)]          # rows 0..7: one entry
        for i in range(8, n):
            locs += [(i, j) for j in {i} | set(rng.integers(0, n, 3).tolist())]
        loc = np.array(sorted(set(locs)))
        val = rng.random(len(loc)).astype(np.float32) * 50 + 1
        return RI.from_coo(loc, val, shape=(n, n)), 2.0
    rng = np.random.default_rng({"random": 5, "zero_costs": 6,
                                 "costs_from_5": 7}[kind])
    n = 48
    if kind == "random":
        loc, val, _ = random_sparse_instance(rng, n, n, 0.15, integer=False)
        return RI.from_coo(loc, val.astype(np.float32), shape=(n, n)), 5.0
    low, high = (0, 4) if kind == "zero_costs" else (5, 10)
    loc, val, _ = random_sparse_instance(rng, n, n, 0.15, low=low,
                                         high=high)
    return RI.from_coo(loc, val.astype(np.float32), shape=(n, n)), 0.5


def _inputs(prob):
    """Host CSR (native), the Pallas layout (padding -2*bigp) and the
    port's (padding = the neg sentinel), with bigp as the hybrid draws
    it."""
    indptr, indices, data = RH.ell_to_csr_transformed(prob, -1, 1)
    bigp = np.float32(data.max() - data.min()) + np.float32(1.0)
    cols = np.asarray(prob.cols)
    valid = np.asarray(prob.valid)
    vals_t = (np.asarray(prob.vals) * np.float32(-1)).astype(np.float32)
    pallas_vals = np.where(valid, vals_t, -2 * bigp).astype(np.float32)
    port_vals = np.where(valid, vals_t, neg_sentinel_np(np.float32))
    return (indptr, indices, data), cols, pallas_vals, port_vals, bigp


def _run_native(csr, prices, owner, eps, bigp, max_bids):
    """Native forward GS from (prices, owner): it queues the unassigned
    rows with entries in ascending order, as the K3 callers here do."""
    prices, owner = prices.copy(), owner.copy()
    n = csr[0].shape[0] - 1
    sigma = np.full(n, -1, np.int32)
    held = owner >= 0
    sigma[owner[held]] = np.flatnonzero(held)
    bids = native_gs(*csr, prices, sigma, owner, np.float32(eps), bigp, 0,
                     max_bids)
    return prices, owner, bids


def _run_both(cols, pallas_vals, port_vals, queue, qcount, prices, owner,
              eps, bigp, max_bids, run_pallas=True):
    port = gs_auction_plain(_t(cols), _t(port_vals), _t(queue), qcount,
                            _t(prices), _t(owner), eps, bigp, max_bids)
    port = [np.asarray(x) for x in port]
    if not run_pallas:
        return port, None
    ref = pallas_gs(jnp.asarray(cols), jnp.asarray(pallas_vals),
                    jnp.asarray(queue), qcount, jnp.asarray(prices),
                    jnp.asarray(owner), eps, bigp, max_bids, interpret=True)
    ref = [np.asarray(x) for x in ref]
    np.testing.assert_array_equal(_bits(port[0]), _bits(ref[0]))
    for a, b in zip(port[1:], ref[1:]):
        np.testing.assert_array_equal(a, b)
    return port, ref


@pytest.mark.parametrize("kind", ["random", "single_entry_rows",
                                  "zero_costs"])
def test_twin_matches_pallas_and_native(kind):
    prob, eps = _instance(kind)
    csr, cols, pallas_vals, port_vals, bigp = _inputs(prob)
    n = m = prob.n
    if kind == "zero_costs":
        assert (np.asarray(prob.vals)[np.asarray(prob.valid)] == 0).any()
    queue = np.full(n + 1, -1, np.int32)
    queue[:n] = np.arange(n)
    prices = np.zeros(m, np.float32)
    owner = np.full(m, -1, np.int32)
    port, _ = _run_both(cols, pallas_vals, port_vals, queue, n, prices,
                        owner, eps, bigp, 10 ** 7)
    p_nat, o_nat, bids = _run_native(csr, prices, owner, eps, bigp, 10 ** 7)
    assert int(port[4]) == 0 and int(port[3]) == bids > n
    np.testing.assert_array_equal(port[1], o_nat)
    np.testing.assert_array_equal(_bits(port[0]), _bits(p_nat))


def test_bid_cap_stops_mid_queue():
    """max_bids leaves the state after exactly max_bids bids, with rows
    still queued; the native engine reports -1 with the same state."""
    prob, eps = _instance("random")
    csr, cols, pallas_vals, port_vals, bigp = _inputs(prob)
    n = m = prob.n
    queue = np.full(n + 1, -1, np.int32)
    queue[:n] = np.arange(n)
    prices = np.zeros(m, np.float32)
    owner = np.full(m, -1, np.int32)
    cap = n + 7
    port, _ = _run_both(cols, pallas_vals, port_vals, queue, n, prices,
                        owner, eps, bigp, cap)
    assert int(port[3]) == cap and int(port[4]) > 0
    p_nat, o_nat, bids = _run_native(csr, prices, owner, eps, bigp, cap)
    assert bids == -1
    np.testing.assert_array_equal(port[1], o_nat)
    np.testing.assert_array_equal(_bits(port[0]), _bits(p_nat))


def test_warm_start_unsorted_queue_wraps_the_ring():
    """Nonzero prices, some columns owned, a queue holding the other rows
    in shuffled order, and a ring of n + 1 that wraps."""
    prob, eps = _instance("random")
    _, cols, pallas_vals, port_vals, bigp = _inputs(prob)
    n = m = prob.n
    rng = np.random.default_rng(3)
    prices = (rng.integers(0, 40, m) * 0.75).astype(np.float32)
    owner = np.full(m, -1, np.int32)
    rows = rng.permutation(n)[:n // 3]
    owner[cols[rows, 0]] = rows             # first column of each row
    owned = owner[owner >= 0]
    rest = np.setdiff1d(np.arange(n), owned)
    queue = np.full(n + 1, -1, np.int32)
    queue[:rest.shape[0]] = rng.permutation(rest)
    port, _ = _run_both(cols, pallas_vals, port_vals, queue, rest.shape[0],
                        prices, owner, eps, bigp, 10 ** 7)
    assert int(port[4]) == 0
    # every bid pops one row and the ring ends empty, so bids = queued +
    # pushes; more than cap = n + 1 of them means the tail wrapped
    assert int(port[3]) > n + 1
    assert (np.sort(port[1][port[1] >= 0]) == np.arange(n)).all()


def test_twin_reads_real_entries_the_native_engine_reads():
    """Costs 5..9: every transformed value is <= -bigp, so the TPU kernel's
    padding rule would drop them all; the port reads padding from the neg
    sentinel and equals the native engine."""
    prob, eps = _instance("costs_from_5")
    csr, cols, _, port_vals, bigp = _inputs(prob)
    n = m = prob.n
    assert (port_vals[np.asarray(prob.valid)] <= -bigp).all()
    queue = np.full(n + 1, -1, np.int32)
    queue[:n] = np.arange(n)
    prices = np.zeros(m, np.float32)
    owner = np.full(m, -1, np.int32)
    port, _ = _run_both(cols, None, port_vals, queue, n, prices, owner, eps,
                        bigp, 10 ** 6, run_pallas=False)
    p_nat, o_nat, bids = _run_native(csr, prices, owner, eps, bigp, 10 ** 6)
    assert int(port[4]) == 0 and int(port[3]) == bids > 0
    np.testing.assert_array_equal(port[1], o_nat)
    np.testing.assert_array_equal(_bits(port[0]), _bits(p_nat))


def test_wrapper_dispatch_and_input_checks():
    prob, eps = _instance("single_entry_rows")
    _, cols, _, port_vals, bigp = _inputs(prob)
    n = m = prob.n
    queue = np.full(n + 1, -1, np.int32)
    queue[:n] = np.arange(n)
    args = [_t(cols), _t(port_vals), _t(queue), n,
            _t(np.zeros(m, np.float32)), _t(np.full(m, -1, np.int32)), eps,
            bigp, 10 ** 6]
    got = gs_auction_device(*args)              # CPU tensors: the twin
    want = gs_auction_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert gs_auction_device.launches == 0
    assert torch.equal(args[2], _t(queue))      # inputs are not mutated
    for i, bad, match in ((3, n + 1, "qcount"), (2, _t(queue + n), "queued"),
                          (5, _t(np.full(m, n, np.int32)), "owner")):
        with pytest.raises(ValueError, match=match):
            gs_auction_device(*args[:i], bad, *args[i + 1:])
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(RuntimeError, match="unsupported device"):
        gs_auction_device(*meta)
