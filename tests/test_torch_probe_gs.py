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
from hypothesis import given, settings, strategies as st
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


# ---------------------------------------------------------------------------
# The redesigned kernels' protocols on the CPU (csrc/probe_queue.cu's pump
# and store passes, csrc/probe_ladder.cu's look-ahead kernel), bit for bit
# against the plain versions.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("blocks", [1, 2, 3, 7, 132])
@pytest.mark.parametrize("n", [0, 1, 2, 16, 17, 1000])
def test_pump_split_matches_plain(n, blocks):
    """P6 over B blocks of contiguous ranges, PUMP_CONSUMERS warps each,
    uint32 partials combined by wrapping addition, on distinct rows (entry
    (r, c) = 131 r + c, large enough to wrap): equal to _queue_plain."""
    hbm = (np.arange(2 * n + 2, dtype=np.int64)[:, None] * 131
           + np.arange(PG.LINE)).astype(np.int32)
    hbm[::3] *= 40_000                 # sums past 2**31
    want = PG.while_double_buffer((n,), torch.from_numpy(hbm))[0]
    got = PG.pump_mirror(hbm, n, blocks)
    assert got.dtype == torch.int32 and got.tolist() == want.tolist()


@pytest.mark.parametrize("n,sms,blocks", [(0, 132, 1), (16, 132, 1),
                                          (64, 132, 1), (65, 132, 2),
                                          (500_000, 132, 132),
                                          (500_000, 114, 114)])
def test_pump_grid(n, sms, blocks):
    assert PG.pump_blocks(n, sms) == blocks


def _ladder_case(first, n, stage, max_bids):
    args, kw = PG.ladder_inputs(n, n, 4, n + 1, unified=True, stage=stage,
                                max_bids=max_bids, first=first, first_mod=8,
                                prices=(np.random.default_rng(5).random(n)
                                        * 4).astype(np.float32))
    return PG.to_device(args, "cpu"), kw


@pytest.mark.parametrize("snapshot,seed", [("stalest", 0), ("random", 1),
                                           ("random", 2)])
@pytest.mark.parametrize("stamp_bits,warps", [(2, 1), (12, 4)])
@pytest.mark.parametrize("first", ["arange", "mod", "three"])
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_ladder_lookahead_mirror_matches_plain(stage, first, stamp_bits,
                                               warps, snapshot, seed):
    """Gather lanes reading stale snapshots (the stalest allowed, or random
    lags), passes of up to 32 cut at a repeated column, stamp validation
    (a 4-entry table forces collisions), the commit warp's own reads of
    recent pushes: acc, prices, owner, queue and stats equal
    _ladder_plain's bit for bit, on instances with repeated first columns
    and evictions."""
    x, kw = _ladder_case(first, 300, stage, 2000)
    want = PG.gs_ladder_uni(*x, **kw)
    st = x[3].clone()
    q, p, o = st[0].numpy(), st[1].view(torch.float32).numpy(), st[2].numpy()
    counts = PG._ladder_args(x[0], x[1], x[2], st[0],
                             st[1].view(torch.float32), st[2], kw["K"],
                             stage)
    stats, acc, cnt = PG.ladder_lookahead_mirror(
        stage, counts, x[1], x[2], q, p, o, kw["K"], gather_warps=warps,
        stamp_bits=stamp_bits, snapshot=snapshot, seed=seed)
    _assert_same(st.numpy(), want[0].numpy())
    assert stats.tolist() == want[1].tolist()
    _assert_same(acc, want[2].numpy())
    assert cnt["from_lane"] + cnt["self"] == stats[0]
    if first != "arange" and stage >= 2 and snapshot == "stalest":
        assert cnt["stale"] > 0            # the instance did conflict
    if first == "three" and stage == 3:
        assert stats.tolist() == [2000, 2]  # a ring of two rows throughout


def test_ladder_inputs_first_columns():
    """first="mod": column u mod first_mod, every row queued; "three": rows
    0-2 queued alone, all on column 0."""
    args, _ = PG.ladder_inputs(40, 40, 3, 41, unified=False, stage=3,
                               first="mod", first_mod=8)
    cols = args[1].reshape(-1)[:40 * 3].reshape(40, 3)
    assert (cols[:, 0] == np.arange(40) % 8).all() and args[0][0] == 40
    args, _ = PG.ladder_inputs(40, 40, 3, 41, unified=True, stage=3,
                               first="three")
    cols = args[1].reshape(-1)[:40 * 3].reshape(40, 3)
    assert (cols[:3, 0] == 0).all() and args[0][0] == 3
    assert args[3][0, :3].tolist() == [0, 1, 2]
    with pytest.raises(ValueError, match="first"):
        PG.ladder_inputs(4, 4, 3, 5, unified=True, stage=1, first="x")
    with pytest.raises(ValueError, match="snapshot"):
        PG.ladder_lookahead_mirror(1, (4, 10, 5), *args[1:3], *(
            np.zeros(8, np.int32),) * 3, 3, snapshot="x")


def _bad_row_instance():
    """n = 65 over hbm = zeros [16, 128] with hbm[4, 0] = 5, hbm[5, 0] =
    -10, and q = zeros with q[0] = 2: iteration 0 reads row 2 and stores
    acc + 7 = 7 at q[64 + 5]; each later one reads row 0 and stores at
    q[64], so iteration 64 reads row -3 (acc = -10)."""
    hbm = torch.zeros(16, PG.LINE, dtype=torch.int32)
    hbm[4, 0], hbm[5, 0] = 5, -10
    q = torch.zeros(1, PG.LINE, dtype=torch.int32)
    q[0, 0] = 2
    return hbm, q


@pytest.mark.parametrize("name,n,pos,rid", [
    ("qdma_store_datadep", 65, 64, -3), ("qdma_store_via_dma", 65, 64, -3),
    # P14 writes float bits at [100, 108): iteration 100 reads 1.5 * 97's
    ("qdma_store_bitcast", 101, 100,
     int(np.float32(1.5 * 97).view(np.int32)))])
def test_queue_loops_raise_at_a_written_bad_row_id(name, n, pos, rid):
    """P13, P14 and P15 read slots their loop wrote; an id there outside
    the tables raises ValueError naming the position and the id (before,
    P13 and P15 returned out = -10, iteration 64 summing rows -6..-5)."""
    hbm, q = _bad_row_instance()
    before = q.clone()
    msg = f"row id {rid} read at position {pos} "
    with pytest.raises(ValueError, match=msg):
        PG.PROBES[name]((n,), hbm, q)
    assert torch.equal(q, before)
    if name == "qdma_store_via_dma":
        with pytest.raises(ValueError, match=msg):
            PG.store_pass_mirror(n, hbm.numpy(), q.numpy().reshape(-1).copy(),
                                 8)
    out = PG.PROBES[name]((pos,), hbm, q)[-1]      # one iteration fewer
    assert out.dtype == torch.int32


def _store_against_plain(n, hbm, q, segment):
    want = PG.qdma_store_via_dma((n,), torch.from_numpy(hbm),
                                 torch.from_numpy(q))
    got_q = q.copy()
    out, count = PG.store_pass_mirror(n, hbm, got_q, hbm.shape[0] // 2,
                                      segment=segment)
    assert out.dtype == torch.int32 and out.tolist() == want[1].tolist()
    np.testing.assert_array_equal(got_q.reshape(want[0].shape),
                                  want[0].numpy())
    return count


def test_store_pass_mirror_at_the_reference_shape():
    """P15's kernel protocol on the probe's own inputs (N = 12): one pass,
    one segment, equal to the plain loop and to the reference's acc."""
    args, _ = PG.make_inputs("qdma_store_via_dma")
    count = _store_against_plain(12, args[1], args[2].reshape(-1).copy(),
                                 None)
    assert count == dict(passes=1, cut=0)


@pytest.mark.parametrize("segment", [128, 160, 512])
def test_store_pass_mirror_cuts_at_written_slots(segment):
    """n from 65 to 200 over 40 seeds: positions 64-95 read slots the loop
    wrote, so passes are cut; with segments of 128 and 160 the merge over
    segment records runs too.  Equal to the plain loop throughout."""
    cuts = 0
    for seed in range(40):
        n = 65 + 135 * seed // 39
        hbm, q = PG.store_inputs(n, 128, seed)
        cuts += _store_against_plain(n, hbm, q, segment)["cut"]
    assert cuts > 0


@settings(max_examples=60, deadline=None)
@given(n=st.integers(0, 200), seed=st.integers(0, 2 ** 31),
       segment=st.sampled_from([128, 192, 512]))
def test_store_pass_mirror_matches_plain_on_drawn_instances(n, seed, segment):
    hbm, q = PG.store_inputs(n, 128, seed)
    _store_against_plain(n, hbm, q, segment)


def test_store_grid():
    assert [PG.store_blocks(n) for n in (0, 1, 512, 513, 2 ** 20)] == [
        1, 1, 1, 2, 2048]
    assert PG.store_blocks(200, 128) == 2


@pytest.mark.parametrize("snapshot,seed", [("stalest", 0), ("random", 1)])
@pytest.mark.parametrize("first", ["arange", "mod", "three"])
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_ladder_lookahead_mirror_on_three_tables(stage, first, snapshot,
                                                 seed):
    """P17 runs the look-ahead kernel on its three tables (queue, f32
    prices, owner): the mirror on those tables equals P17's plain version
    bit for bit."""
    args, kw = PG.ladder_inputs(300, 300, 4, 301, unified=False, stage=stage,
                                max_bids=2000, first=first, first_mod=8,
                                prices=(np.random.default_rng(5).random(300)
                                        * 4).astype(np.float32))
    x = PG.to_device(args, "cpu")
    want = PG.gs_ladder(*x, **kw)
    q, p, o = (t.clone().reshape(-1) for t in x[3:])
    counts = PG._ladder_args(x[0], x[1], x[2], q, p, o, kw["K"], stage)
    stats, acc, cnt = PG.ladder_lookahead_mirror(
        stage, counts, x[1], x[2], q.numpy(), p.numpy(), o.numpy(), kw["K"],
        snapshot=snapshot, seed=seed)
    for got, ref in zip((q, p, o), want[:3]):
        _assert_same(got.numpy(), ref.reshape(-1).numpy())
    assert stats.tolist() == want[3].tolist()
    _assert_same(acc, want[4].numpy())
    assert cnt["from_lane"] + cnt["self"] == stats[0]


# ---------------------------------------------------------------------------
# P7, P8, P10-P12 and P14's pass kernel (csrc/probe_queue.cu,
# queue_pass_kernel) on the CPU, and P9 and P13 on P6's and P15's kernels,
# bit for bit against the plain loops.
# ---------------------------------------------------------------------------

_PASS_PROBES = ("while_qtable_dma", "while_qtable_dma_store", "qdma_dual",
                "qdma_alias3", "qdma_alias2", "qdma_store_bitcast")
_PAIRS = 128


def _pass_against_plain(name, n, inst, segment):
    """queue_pass_mirror on ``inst`` (queue_inputs) against the probe's
    plain loop: the same out and queue, or the same ValueError.  Returns
    the mirror's counts, or None where both raised."""
    kernel = PG.PROBES[name]
    tables = {k: torch.from_numpy(v.copy()) for k, v in inst.items()}
    try:
        want, err = kernel((n,), *PG.queue_tables(kernel, tables)), None
    except ValueError as e:
        want, err = None, str(e)
    q = inst["q"].copy()
    try:
        out, count = PG.queue_pass_mirror(
            PG._QUEUE_VARIANTS[name], n, inst["hbm"], q, _PAIRS,
            inst["vbm"], inst["pt"], inst["ot"], segment=segment)
    except ValueError as e:
        assert str(e) == err
        return None
    assert err is None, err
    assert out.dtype == torch.int32 and out.tolist() == want[-1].tolist()
    np.testing.assert_array_equal(q, want[0].numpy().reshape(-1))
    for got, key in zip(want[1:-1], ("pt", "ot")):
        np.testing.assert_array_equal(got.numpy(), inst[key])
    return count


@pytest.mark.parametrize("segment", [None, 64])
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 12, 31, 32, 33, 127, 128, 129,
                               513, 2000])
@pytest.mark.parametrize("name", _PASS_PROBES)
def test_queue_pass_mirror_matches_plain(name, n, segment):
    """Drawn queues (ids over 128 row pairs, rows of random int32 that
    wrap, vbm rows of small integers, random prices and owners), segments
    of 512 or 64: the mirror equals the plain loop, P14 raising at
    position 100 past n = 100 (it reads the float bits the loop stored).
    P8's ids stay below 48, so that its pushes (+ 20 a link) stay in
    range."""
    inst = PG.queue_inputs(n, _PAIRS, n)
    if name == "while_qtable_dma_store":
        inst["q"][:n] %= _PAIRS - 80
    count = _pass_against_plain(name, n, inst, segment)
    if name == "qdma_store_bitcast" and n > 100:
        assert count is None
        return
    total = PG.queue_total(PG._QUEUE_VARIANTS[name], n)
    assert count["segments"] == PG.queue_blocks(total, segment)
    assert count["passes"] == sum(
        -(-min(total - lo, segment or PG.QUEUE_SEGMENT) // 32)
        for lo in range(0, total, segment or PG.QUEUE_SEGMENT))
    if name == "while_qtable_dma_store":
        assert count["forwarded"] == (4 if n else 0)


def _place_bad(inst, name, n, positions):
    """Out-of-range ids at ``positions`` (alternately below 0 and at or
    past the 128 row pairs); a P8 position p in [n, n + 4) through the
    slot its id is forwarded from, q[p mod n], which then stays in range
    itself only when p < 2 n."""
    q = inst["q"]
    for j, p in enumerate(positions):
        if name == "while_qtable_dma_store" and p >= n:
            q[p % n] = _PAIRS - 20 if p < 2 * n else _PAIRS
        else:
            q[p] = -1 - j if j % 2 == 0 else _PAIRS + j


@pytest.mark.parametrize("segment", [None, 64])
@pytest.mark.parametrize("positions", [(0,), (31,), (32,), (63,), (64,),
                                       (95, 40), (511,), (512,), (700, 600),
                                       (33, 599, 1)])
@pytest.mark.parametrize("name", _PASS_PROBES)
def test_queue_pass_mirror_stops_at_the_first_bad_id(name, positions,
                                                     segment):
    """Bad ids at pass (32) and segment (64, 512) boundaries, one or more
    (the lowest position wins, also when a later segment holds another):
    the mirror raises the plain loop's ValueError, naming the first bad
    position in position order and its id."""
    n = 800
    inst = PG.queue_inputs(n, _PAIRS, 7)
    _place_bad(inst, name, n, positions)
    assert _pass_against_plain(name, n, inst, segment) is None


@pytest.mark.parametrize("k", [None, 1, 2, 3, 4])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_queue_pass_mirror_p8_pushes_chain_below_four(n, k):
    """P8 with n < 4: position n + i reads the push of position i, itself
    pushed when i >= n, so ids chain (q[p mod n] + 20 (p // n)).  With
    q[0] = 128 - 20 k (the other ids below 48) the k-th link, position k n,
    reads 128, past the tables: both stop there if it lies below n + 4,
    and both run to the end otherwise."""
    inst = PG.queue_inputs(n, _PAIRS, 11)
    inst["q"][:n] %= _PAIRS - 80
    if k is not None:
        inst["q"][0] = _PAIRS - 20 * k
    stops = k is not None and k * n < n + 4
    count = _pass_against_plain("while_qtable_dma_store", n, inst, None)
    assert (count is None) == stops
    if stops:
        with pytest.raises(ValueError, match=(
                f"row id {_PAIRS} read at position {k * n} ")):
            PG.queue_pass_mirror(8, n, inst["hbm"], inst["q"].copy(),
                                 _PAIRS)
    else:
        assert count["forwarded"] == 4


@pytest.mark.parametrize("n", [99, 100, 101, 107, 108, 300])
def test_queue_pass_mirror_p14_past_position_100(n):
    """P14's position p in [100, 108) reads the bits of 1.5 (p - 3), which
    iteration p - 4 stored, far outside the tables: from n = 101 both raise
    at position 100 with that id; up to 100 the eight slots hold the last
    writer's bits."""
    count = _pass_against_plain("qdma_store_bitcast", n,
                                PG.queue_inputs(n, _PAIRS, 3), 64)
    assert (count is None) == (n > 100)
    if n > 100:
        with pytest.raises(ValueError, match=(
                f"row id {int(np.float32(1.5 * 97).view(np.int32))} read "
                f"at position 100 ")):
            PG.queue_pass_mirror(14, n, *(PG.queue_inputs(n, _PAIRS, 3)[k]
                                          for k in ("hbm", "q")), _PAIRS)


@settings(max_examples=60, deadline=None)
@given(name=st.sampled_from(_PASS_PROBES), n=st.integers(0, 300),
       seed=st.integers(0, 2 ** 31), segment=st.sampled_from([32, 64, 512]),
       bad=st.lists(st.integers(0, 310), max_size=2))
def test_queue_pass_mirror_matches_plain_on_drawn_instances(name, n, seed,
                                                            segment, bad):
    inst = PG.queue_inputs(n, _PAIRS, seed)
    _place_bad(inst, name, n, [p for p in bad
                               if p < PG.queue_total(
                                   PG._QUEUE_VARIANTS[name], n)])
    _pass_against_plain(name, n, inst, segment)


def test_queue_grid():
    assert [PG.queue_total(8, n) for n in (0, 1, 12)] == [0, 5, 16]
    assert [PG.queue_total(7, n) for n in (0, 12)] == [0, 12]
    assert [PG.queue_blocks(t) for t in (0, 1, 512, 513, 2 ** 20)] == [
        1, 1, 1, 2, 2048]
    assert PG.queue_blocks(65, 32) == 3


@pytest.mark.parametrize("blocks", [1, 3, 132])
@pytest.mark.parametrize("n", [0, 1, 8, 17, 1000])
def test_pump_mirror_holds_p9(n, blocks):
    """P9 computes P6's function, so it runs P6's pump kernel: the pump's
    split equals P9's plain loop (start + wait, a flipping slot)."""
    hbm = (np.arange(2 * n + 2, dtype=np.int64)[:, None] * 131
           + np.arange(PG.LINE)).astype(np.int32)
    hbm[::3] *= 40_000
    want = PG.sem_2d_dynamic((n,), torch.from_numpy(hbm))[0]
    assert PG.pump_mirror(hbm, n, blocks).tolist() == want.tolist()


@pytest.mark.parametrize("segment", [128, 512])
@pytest.mark.parametrize("n", [0, 1, 12, 64, 65, 96, 97, 200, 700])
def test_store_pass_mirror_holds_p13(n, segment):
    """P13 computes P15's function, so it runs P15's store passes: the
    mirror equals P13's plain loop, queue and out, over 4 seeds."""
    for seed in range(4):
        hbm, q = PG.store_inputs(n, 128, seed)
        want = PG.qdma_store_datadep((n,), torch.from_numpy(hbm),
                                     torch.from_numpy(q))
        got_q = q.copy()
        out, _ = PG.store_pass_mirror(n, hbm, got_q, 128, segment=segment)
        assert out.tolist() == want[1].tolist()
        np.testing.assert_array_equal(got_q, want[0].numpy())
