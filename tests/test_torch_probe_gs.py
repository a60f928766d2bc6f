"""The GS micro-probes' plain versions (sslap_tpu_torch.ops.probe_gs, what
each probe wrapper runs on CPU tensors) against the reference probes
(benchmarks/probe_mosaic_gs.py) run in Pallas interpret mode on the CPU.

Every reference probe builds its own inputs and calls ``pallas_call``;
the test wraps ``jax.experimental.pallas.pallas_call`` (through
monkeypatch, so nothing leaks into other tests of the worker) to pass
``interpret=True`` and record what the call returns, then runs the port's
plain version on the inputs ``probe_gs.make_inputs`` builds the same way.
Tolerance: exact, every output bit for bit (int32, or float32 made by the
same ops in the same order).  The ladder kernels are also held against a
numpy loop at a second size.  The kernels themselves run only on a CUDA
device (tests/test_torch_cuda.py).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sslap_tpu_torch.ops import probe_gs as PG

_REF = Path(__file__).resolve().parent.parent / "benchmarks" / \
    "probe_mosaic_gs.py"


@pytest.fixture(scope="module")
def reference():
    spec = importlib.util.spec_from_file_location("probe_mosaic_gs_ref",
                                                  _REF)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_outputs(monkeypatch, reference, name):
    """Run reference probe ``name`` in interpret mode; the outputs of its
    (last) pallas_call as numpy arrays."""
    calls = []
    compiled = pl.pallas_call

    def interpreted(*args, **kw):
        kw["interpret"] = True
        fn = compiled(*args, **kw)

        def run(*inputs):
            out = fn(*inputs)
            calls.append(out)
            return out
        return run

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    reference.PROBES[name]()
    out = calls[-1]
    return [np.asarray(o) for o in (out if isinstance(out, (tuple, list))
                                    else (out,))]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same(got, want):
    got = np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_registry_matches_the_reference(reference):
    assert list(PG.PROBES) == list(reference.PROBES)
    assert sorted(PG.ORDER) == sorted(reference.PROBES)
    assert len(PG.KERNELS) == 17


@pytest.mark.parametrize("name", list(PG.PROBES))
def test_plain_matches_interpreted_reference(monkeypatch, reference, name):
    want = _reference_outputs(monkeypatch, reference, name)
    out = PG.run(name, "cpu")
    PG.check(name, out)
    got = [o.numpy() for o in out]
    if name.startswith("gs_small"):
        # the pallas_call's padded [1, 128] tables and stats, as the
        # reference's gs_auction_device unpacks them
        q, p, o, stats = want
        want = [p.reshape(-1)[:32], o.reshape(-1)[:32], q.reshape(-1)[:33]]
        for a, b in zip(got[:3], want):
            _assert_same(a, b)
        assert (int(got[3]), int(got[4])) == (int(stats[0]), int(stats[1]))
        return
    if name.startswith(("gs_uni", "gs_ladder")):
        got = got[:-1]                      # acc: see the numpy-loop test
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _assert_same(a, b)


def _numpy_ladder(stage, n, m, K):
    """The reference ladder's loop (probe_mosaic_gs.py:903-935) over its
    construction, in numpy: final prices, owner, queue, bids, left, acc."""
    rng = np.random.default_rng(3)
    cols = np.sort(rng.integers(0, m, (n, K)), axis=1).astype(np.int32)
    cols[:, 0] = np.arange(n)
    vals = (rng.random((n, K)) * 10).astype(np.float32)
    cap = n + 1
    prices = np.zeros(m, np.float32)
    owner = np.full(m, -1, np.int32)
    queue = np.zeros(cap, np.int32)
    queue[:n] = np.arange(n)
    zero = np.float32(0)
    acc, head, tail, bids = zero, 0, n, 0
    while head != tail:
        u = queue[head]
        head = (head + 1) % cap
        j = cols[u, 0]
        pk = prices[j] + zero
        acc = (acc + pk) + (vals[u, 0] + zero)
        if stage >= 3 and owner[j] >= 0:
            queue[tail] = owner[j]
            tail = (tail + 1) % cap
        if stage >= 2:
            prices[j] = pk + np.float32(0.5)
            owner[j] = u
        bids += 1
    return prices, owner, queue, bids, (tail - head) % cap, acc


@pytest.mark.parametrize("unified", [True, False])
@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("n,K", [(32, 4), (300, 6)])
def test_ladder_plain_matches_numpy_loop(n, K, stage, unified):
    args, kw = PG.ladder_inputs(n, n, K, n + 1, unified=unified, stage=stage)
    kernel = PG.gs_ladder_uni if unified else PG.gs_ladder
    out = kernel(*PG.to_device(args, "cpu"), **kw)
    prices, owner, queue, bids, left, acc = _numpy_ladder(stage, n, n, K)
    if unified:
        st = out[0].numpy()
        q, p, o = st[0], st[1].view(np.float32), st[2]
    else:
        q, p, o = (t.numpy().reshape(-1) for t in out[:3])
    _assert_same(p[:n], prices)
    _assert_same(o[:n], owner)
    _assert_same(q[:n + 1], queue)
    assert out[-2].tolist() == [bids, left] == [n, 0]
    _assert_same(out[-1].numpy(), np.array([acc], np.float32))
    if stage == 1:       # no stores: the tables are the inputs
        assert (o == -1).all() and (p == 0).all()


def test_wrappers_take_the_plain_version_on_cpu_tensors():
    for name in PG.PROBES:
        if PG.PROBES[name] is PG.gs_auction_device:
            continue
        got = PG.run(name, "cpu")
        want = PG.run(name, "cpu", plain=True)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert all(k.launches == 0 for k in PG.KERNELS.values())
    args, kw = PG.make_inputs("while_qtable_dma")
    x = PG.to_device(args, "cpu")
    before = x[2].clone()
    PG.while_qtable_dma(*x, **kw)
    assert torch.equal(x[2], before)          # aliased tables are copied


def test_wrappers_reject_bad_inputs():
    args, _ = PG.make_inputs("dma_hbm_dynrows")
    x = PG.to_device(args, "cpu")[1]
    with pytest.raises(ValueError, match="rows"):
        PG.dma_hbm_dynrows((63,), x)
    with pytest.raises(ValueError, match="scratch"):
        PG.dma_vmem_dynoff8((5, 2), x)
    with pytest.raises(ValueError, match="int32"):
        PG.dma_hbm_dynrows((5,), x.float())
    args, _ = PG.make_inputs("while_qtable_dma")
    s, hbm, q = PG.to_device(args, "cpu")
    with pytest.raises(ValueError, match="row id"):
        PG.while_qtable_dma((12,), hbm[:16], q)
    args, kw = PG.make_inputs("gs_ladder3")
    a = PG.to_device(args, "cpu")
    with pytest.raises(ValueError, match="cap"):
        PG.gs_ladder((32, 10, 129), *a[1:], **kw)
    with pytest.raises(ValueError, match="stage"):
        PG.gs_ladder(*a, K=4, stage=4)
    meta = [t.to("meta") if isinstance(t, torch.Tensor) else t for t in a]
    with pytest.raises(RuntimeError, match="unsupported device"):
        PG.gs_ladder(*meta, **kw)
