"""The port's CUDA kernels on a card: each against its plain PyTorch twin
(K3 also against the native Gauss-Seidel engine, with and without its
prefetch; the eps-phase ladder through the tiered solve against the same
solve on the CPU; K1's batched entry and the dense bid kernel DK), the GS
micro-probe kernels (P1-P17) against their plain versions, the hybrid
(square and rectangular), device-mode, batched and dense-engine solves on
CUDA against the same solves on the CPU, and the differential fuzz on the
card against its CPU twin.

Marked ``cuda``; every test skips without a CUDA device.  This file imports
neither jax nor the JAX package, so it also runs where only torch is
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: exact (targets, winners, owner, sigma equal; bids and prices
bit for bit).
"""

import numpy as np
import pytest
import torch

import sslap_tpu_torch as P
from sslap_tpu_torch import _native
from sslap_tpu_torch import auction as PA
from sslap_tpu_torch import compact as PC
from sslap_tpu_torch import hybrid as PH
from sslap_tpu_torch.auction import neg_sentinel_np
from sslap_tpu_torch import batch as PB
from sslap_tpu_torch import dense_batch as PD
from sslap_tpu_torch.ops import bid_topk, bid_topk_batched, \
    bid_topk_batched_plain, bid_topk_plain, commit, commit_plain, dense_bid, \
    dense_bid_plain, gs_auction_device, gs_auction_plain, ladder_phase
from sslap_tpu_torch.ops import probe_gs as PG
from sslap_tpu_torch.ops import bid as PBid
from sslap_tpu_torch.ops import gs_kernel as PGS

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bits(t):
    a = t.cpu().numpy()
    return a.view(np.int32) if a.dtype == np.float32 else a


def _state(rng, n, K, dtype, dev):
    """Rows of K sorted distinct columns, the first nvalid of them real
    (0 and 1 included), value ties, a partial matching, random prices."""
    m = n
    start = rng.integers(0, m, n)
    step = rng.integers(1, m // K, n)
    cols = np.sort((start[:, None] + np.arange(K) * step[:, None]) % m, 1)
    nvalid = rng.integers(0, K + 1, n).astype(np.int32)
    valid = np.arange(K) < nvalid[:, None]
    cols = np.where(valid, cols, 0).astype(np.int32)
    if dtype == np.float32:
        vals = -(rng.integers(1, 50, (n, K)) * 2.5).astype(np.float32)
        prices = (rng.integers(0, 20, m) * 1.25).astype(np.float32)
        eps, bigp = np.float32(0.25), np.float32(130.0)
    else:
        vals = -(rng.integers(1, 50, (n, K)) * (m + 1)).astype(np.int32)
        prices = (rng.integers(0, 20, m) * (m + 1)).astype(np.int32)
        eps, bigp = np.int32(3), np.int32(50 * (m + 1) + 1)
    sigma = np.full(n, -1, np.int32)
    owner = np.full(m, -1, np.int32)
    rows = np.flatnonzero(nvalid > 0)
    _, first = np.unique(cols[rows, 0], return_index=True)
    keep = rows[first][rng.random(first.shape[0]) < 0.6]
    sigma[keep] = cols[keep, 0]
    owner[cols[keep, 0]] = keep
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    return dict(cols=t(cols), vals_m=t(np.where(valid, vals,
                                                neg_sentinel_np(dtype))),
                nvalid=t(nvalid), prices=t(prices), sigma=t(sigma),
                owner=t(owner), eps=eps, bigp=bigp)


def _unaligned(t):
    """A copy of t whose data starts 4 bytes past a 16-byte boundary: K1
    then takes 4-byte loads whatever K is."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


ROW_GROUPS = (1, 2, 4, 8, 16, 32)     # the row groups csrc/bid.cu takes


def _row_groups(monkeypatch, K, cols, vals_m):
    """Every (cols, vals_m) K1 can run, each under every row group: the
    one K1 picks from K, then each of ROW_GROUPS forced through
    ops.bid.row_group; with 16-byte row loads where K % 4 == 0 and with
    4-byte loads from unaligned copies."""
    tables = [(cols, vals_m)]
    if K % 4 == 0:
        tables.append((_unaligned(cols), _unaligned(vals_m)))
    pick = PBid.row_group
    for c, v in tables:
        monkeypatch.setattr(PBid, "row_group", pick)
        yield c, v
        for G in ROW_GROUPS:
            monkeypatch.setattr(PBid, "row_group", lambda K, cols, vals_m,
                                G=G: (G, pick(K, cols, vals_m)[1]))
            yield c, v
    monkeypatch.setattr(PBid, "row_group", pick)


K_GRID = [1, 2, 3, 5, 10, 17, 52, 64]


@pytest.mark.parametrize("K", K_GRID)
@pytest.mark.parametrize("phase_start", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_kernels_match_twins(dev, monkeypatch, dtype, phase_start, K):
    """K1 then K2 against their plain versions on one round, for every row
    group K1 can run at this K; the id list is shuffled, with dead slots
    (id = n) among the live ones."""
    rng = np.random.default_rng(11 + K)
    n = 5000
    st = _state(rng, n, K, dtype, dev)
    sig, nv = st["sigma"].cpu().numpy(), st["nvalid"].cpu().numpy()
    if phase_start:
        live = np.flatnonzero(((sig < 0) & (nv > 0)) | (sig >= 0))
    else:
        live = np.flatnonzero((sig < 0) & (nv > 0))[:3000]
    ids = np.full(live.shape[0] + 600, n, np.int32)
    ids[:live.shape[0]] = live
    ids = torch.from_numpy(rng.permutation(ids)).to(dev)

    def run(k1, k2, cols, vals_m):
        prices, sigma, owner = (st[k].clone() for k in
                                ("prices", "sigma", "owner"))
        tgt, bid = k1(ids, cols, vals_m, st["nvalid"], prices, sigma, owner,
                      st["eps"], st["bigp"], phase_start=phase_start)
        stay, evicted, counts = k2(ids, tgt, bid, prices, owner, sigma)
        return tgt, bid, prices, sigma, owner, stay, evicted, counts

    want = run(bid_topk_plain, commit_plain, st["cols"], st["vals_m"])
    for cols, vals_m in _row_groups(monkeypatch, K, st["cols"],
                                    st["vals_m"]):
        got = run(bid_topk, commit, cols, vals_m)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_bits(a), _bits(b))
    assert int(want[7][0]) > 0


@pytest.mark.parametrize("case", [
    dict(n=5000, C=2000, ncols=40),                 # a few columns
    dict(n=300_000, C=131_072, ncols=1),            # every bid on one
    dict(n=300_000, C=131_072, ncols=8),
    dict(n=300_000, C=131_072, ncols=8, equal=True),
    dict(n=300_000, C=131_072, ncols=None),         # any column
])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_commit_kernel_matches_twin_on_ties(dev, dtype, case):
    """Equal, +-0.0 and negative bids onto a few columns, some owned; heavy
    contention at C = 131,072 (all bids on 1 or 8 columns; all bids equal,
    so the lowest row wins); ids in any order, 10% without a bid.  Outputs,
    counts and tables equal the plain version's, and keys is all zero
    again."""
    rng = np.random.default_rng(12)
    n, C = case["n"], case["C"]
    st = _state(rng, n, 10, dtype, dev)
    sig = st["sigma"].cpu().numpy()
    ids = rng.choice(np.flatnonzero(sig < 0), C, replace=False)
    if case["ncols"] is None:
        cols = np.arange(n)
    else:
        owned = np.flatnonzero(st["owner"].cpu().numpy() >= 0)
        half = case["ncols"] // 2
        cols = np.concatenate([owned[:half], rng.choice(
            n, case["ncols"] - half, replace=False)])
    tgt = rng.choice(cols, C).astype(np.int32)
    tgt[rng.random(C) < 0.1] = n
    choices = (np.array([-1.5, -0.0, 0.0, 2.0], np.float32)
               if dtype == np.float32 else np.array([-3, 0, 5], np.int32))
    bid = rng.choice(choices[-1:] if case.get("equal") else choices, C)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    ids, tgt, bid = t(ids.astype(np.int32)), t(tgt), t(bid)
    keys = torch.zeros(n, dtype=torch.int64, device=dev)
    outs = []
    for fn, kw in ((commit, dict(keys=keys)), (commit_plain, {})):
        state = [st[k].clone() for k in ("prices", "owner", "sigma")]
        outs.append(list(fn(ids, tgt, bid, *state, **kw)) + state)
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert int(keys.count_nonzero()) == 0
    assert int(outs[0][2][0]) == int(torch.unique(tgt[tgt < n]).numel())


def _instance(n, seed=16, k=8):
    rng = np.random.default_rng(seed)
    rr = np.concatenate([np.repeat(np.arange(n), k), np.arange(n)])
    cc = np.concatenate([rng.integers(0, n, n * k), rng.permutation(n)])
    _, idx = np.unique(rr * n + cc, return_index=True)
    rr, cc = rr[idx], cc[idx]
    val = (rng.random(rr.shape[0]) * 999 + 1).astype(np.float32)
    return np.stack([rr, cc], 1), val


def _rect_instance(n, m, seed=18, k=6):
    rng = np.random.default_rng(seed)
    rr = np.concatenate([np.repeat(np.arange(n), k), np.arange(n)])
    cc = np.concatenate([rng.integers(0, m, n * k),
                         rng.permutation(m)[:n]])
    _, idx = np.unique(rr * m + cc, return_index=True)
    return np.stack([rr[idx], cc[idx]], 1), rng.integers(1, 1000, idx.shape[0])


# bid warps beside K3's commit warp: none (prefetch=False's path), one,
# four, and the module's default
GS_WARPS = [0, 1, 4, None]


def _set_bid_warps(monkeypatch, warps):
    if warps is not None:
        monkeypatch.setattr(PGS, "BID_WARPS", warps)
    return PGS.BID_WARPS


def _check_gs_counters(out, prefetch=True, ring=None):
    """The last launch's counters: bids and rows left as returned, the
    ring histogram adds up (and equals ``ring``, the serial run's, when
    given), and with bid warps speculative + redone + single-row = bids."""
    cnt = gs_auction_device.counters()
    bids = int(out[3])
    assert cnt["bids"] == bids and cnt["left"] == int(out[4])
    assert sum(cnt["ring"].values()) == bids
    assert cnt["single_row_ring"] == cnt["ring"]["1"]
    if ring is not None:
        assert cnt["ring"] == ring
    if prefetch and gs_auction_device.bid_warps:
        assert cnt["speculative"] + cnt["redone"] \
            + cnt["single_row_ring"] == bids
    else:
        assert cnt["speculative"] == cnt["redone"] == 0
    return cnt


@pytest.mark.parametrize("warps", GS_WARPS)
@pytest.mark.parametrize("n,k", [(3000, 8), (400, 60)])
def test_gs_kernel_matches_twin_and_native(dev, n, k, warps, monkeypatch):
    """K3 from a cold start: capped, against the twin (all five outputs);
    to the end, against the native forward GS (prices bit for bit).  K = 60
    puts two slots on some lanes.  Each number of look-ahead bid warps
    (the module constant), with the counters checked."""
    want_warps = _set_bid_warps(monkeypatch, warps)
    loc, val = _instance(n, seed=19, k=k)
    val = val.copy()
    val[::17] = 0                                 # zero costs: -0.0 values
    prob = P.from_coo(loc, val, shape=(n, n))
    indptr, indices, data = PH.ell_to_csr_transformed(prob, -1, 1)
    bigp = np.float32(data.max() - data.min()) + np.float32(1.0)
    vals_m = np.where(prob.valid, -prob.vals, neg_sentinel_np(np.float32))
    queue = np.full(n + 1, -1, np.int32)
    queue[:n] = np.arange(n)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    args = (t(prob.cols), t(vals_m), t(queue), n,
            t(np.zeros(n, np.float32)), t(np.full(n, -1, np.int32)),
            np.float32(0.5), bigp)
    before = gs_auction_device.launches
    got = gs_auction_device(*args, 2 * n)
    want = gs_auction_plain(*args, 2 * n)
    torch.cuda.synchronize()
    assert gs_auction_device.launches == before + 1
    assert gs_auction_device.bid_warps == want_warps
    assert int(got[3]) == 2 * n and int(got[4]) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    serial = PGS.gs_lookahead_mirror(*[a.cpu() if torch.is_tensor(a) else a
                                       for a in args], 2 * n, warps=0)[1]
    _check_gs_counters(got, ring=serial["ring"])
    full = gs_auction_device(*args, 10 ** 9)
    _check_gs_counters(full)
    prices = np.zeros(n, np.float32)
    sigma = np.full(n, -1, np.int32)
    owner = np.full(n, -1, np.int32)
    bids = _native.auction_gs(indptr, indices, data, prices, sigma, owner,
                              np.float32(0.5), bigp, 0, 10 ** 9)
    assert int(full[3]) == bids > n and int(full[4]) == 0
    np.testing.assert_array_equal(full[1].cpu().numpy(), owner)
    np.testing.assert_array_equal(_bits(full[0]), prices.view(np.int32))


@pytest.mark.parametrize("warps", GS_WARPS)
@pytest.mark.parametrize("scan", ["full", "const", "noprices"])
def test_gs_kernel_prefetch_does_not_change_results(dev, scan, warps,
                                                    monkeypatch):
    """K3 with and without prefetch (the look-ahead bid warps): identical
    outputs, equal to the twin.  K = 40 puts two slots on some lanes; a
    3-row ring wraps while it drains, so the ring-of-one path runs."""
    _set_bid_warps(monkeypatch, warps)
    for n, k, queued in ((2000, 40, 2000), (600, 8, 3)):
        loc, val = _instance(n, seed=21, k=k)
        prob = P.from_coo(loc, val, shape=(n, n))
        vals_m = np.where(prob.valid, -prob.vals,
                          neg_sentinel_np(np.float32))
        queue = np.full(n + 1, -1, np.int32)
        queue[:queued] = np.arange(queued)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
        args = (t(prob.cols), t(vals_m), t(queue), queued,
                t(np.zeros(n, np.float32)), t(np.full(n, -1, np.int32)),
                np.float32(0.5), np.float32(1000.0),
                10 ** 9 if scan == "full" else 3 * n)
        outs = [fn(*args, prefetch=pf, _scan=scan) for fn, pf in (
            (gs_auction_device, True), (gs_auction_device, False),
            (gs_auction_plain, True))]
        torch.cuda.synchronize()
        for other in outs[1:]:
            for a, b in zip(outs[0], other):
                np.testing.assert_array_equal(_bits(a), _bits(b))
        assert int(outs[0][3]) >= queued
        ring = _check_gs_counters(outs[1], prefetch=False)["ring"]
        again = gs_auction_device(*args, prefetch=True, _scan=scan)
        _check_gs_counters(again, prefetch=scan == "full", ring=ring)


def _gs_case(case, dev):
    """K3 arguments of a look-ahead stress case (the shapes of
    test_torch_gs_kernel.py's CPU mirror cases, larger): "conflicts" (every
    row on 4 of 6 hot columns), "chain" (one row queued, every other
    matched: a ring of one row throughout), "k52" (rows of 52 slots, two
    lane groups), "k1" (one slot a row, two rows on each column: no
    assignment exists, it stops at max_bids with rows left)."""
    rng = np.random.default_rng({"conflicts": 51, "chain": 52, "k52": 53,
                                 "k1": 54}[case])
    n = m = 2048
    K = {"conflicts": 5, "chain": 4, "k52": 52, "k1": 1}[case]
    if case == "conflicts":
        pick = lambda i: [i, *rng.choice(6, 4, replace=False)]  # noqa
    elif case == "chain":
        pick = lambda i: [i, *rng.integers(1, m, 3)]  # noqa
    elif case == "k52":
        pick = lambda i: [i, *rng.integers(0, m, int(rng.integers(0, K)))]  # noqa
    else:
        pick = lambda i: [i // 2]  # noqa
    cols = np.zeros((n, K), np.int32)
    vals = np.full((n, K), neg_sentinel_np(np.float32), np.float32)
    for i in range(n):
        c = np.unique(np.asarray(pick(i)))[:K]
        cols[i, :c.shape[0]] = c
        vals[i, :c.shape[0]] = -(rng.random(c.shape[0]) * 30).astype(
            np.float32)
    if case == "conflicts":
        vals[cols >= 6] -= 40
    prices = np.zeros(m, np.float32)
    owner = np.full(m, -1, np.int32)
    queue = np.full(n + 1, -1, np.int32)
    queue[:n], qcount = np.arange(n), n
    if case == "chain":
        vals[0, 0] -= 60
        owner[1:] = np.arange(1, n)
        queue[0], qcount = 0, 1
    real = vals[vals > neg_sentinel_np(np.float32) / 2]
    bigp = np.float32(real.max() - real.min()) + np.float32(61.0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    return (t(cols), t(vals), t(queue), qcount, t(prices), t(owner),
            np.float32(0.375), bigp)


@pytest.mark.parametrize("warps", GS_WARPS)
@pytest.mark.parametrize("case", ["conflicts", "chain", "k52", "k1"])
def test_gs_kernel_lookahead_cases(dev, case, warps, monkeypatch):
    """Conflict-heavy, single-chain, two-lane-group and one-slot rows:
    K3 with each number of bid warps against the twin (all five outputs,
    prices bit for bit), the counters adding up and the ring histogram
    equal to the serial run's."""
    _set_bid_warps(monkeypatch, warps)
    args = _gs_case(case, dev)
    max_bids = 20_000
    got = gs_auction_device(*args, max_bids)
    want = gs_auction_plain(*args, max_bids)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    serial = PGS.gs_lookahead_mirror(*[a.cpu() if torch.is_tensor(a) else a
                                       for a in args], max_bids, warps=0)[1]
    cnt = _check_gs_counters(got, ring=serial["ring"])
    if case == "chain":
        assert cnt["single_row_ring"] == int(got[3]) > args[0].shape[0]
    if case == "k1":
        assert int(got[3]) == max_bids and int(got[4]) > 0


@pytest.mark.parametrize("name", list(PG.PROBES))
def test_probe_kernel_matches_plain(dev, name):
    kernel = PG.PROBES[name]
    before = kernel.launches
    got = PG.run(name, "cuda")
    want = PG.run(name, "cuda", plain=True)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    PG.check(name, got)


@pytest.mark.parametrize("unified", [True, False])
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_ladder_kernels_at_scale(dev, stage, unified):
    """n = m = 20,000, K = 10 (two 16-entry windows per row can straddle
    a 128-entry line), random starting prices: kernel == plain version."""
    n = 20_000
    p0 = (np.random.default_rng(4).random(n) * 10).astype(np.float32)
    args, kw = PG.ladder_inputs(n, n, 10, n + 1, unified=unified,
                                stage=stage, prices=p0)
    kernel = PG.gs_ladder_uni if unified else PG.gs_ladder
    x = PG.to_device(args, dev)
    got, want = kernel(*x, **kw), kernel.plain(*x, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert got[-2].tolist() == [n, 0]


def _distinct_rows(rows, dev):
    """A [rows, 128] int32 table with entry (r, c) = 131 r + c, so a wrong
    row changes the sum."""
    return (torch.arange(rows, dtype=torch.int64, device=dev)[:, None] * 131
            + torch.arange(PG.LINE, device=dev)).to(torch.int32)


@pytest.mark.parametrize("n", [0, 1, 16, 17, 1000, 20_000])
def test_pump_kernel_matches_plain(dev, n):
    """P6 over its grid (one block up to 64 iterations, then one per 64,
    at most one per SM), distinct row values: kernel == plain version ==
    the closed form sum of rows 2i, wrapped to int32."""
    hbm = _distinct_rows(2 * n + 2, dev)
    got = PG.while_double_buffer((n,), hbm)[0]
    want = PG.while_double_buffer.plain((n,), hbm)[0]
    torch.cuda.synchronize()
    closed = (131 * 2 * PG.LINE * (n * (n - 1) // 2)
              + (PG.LINE * (PG.LINE - 1) // 2) * n)
    assert got.tolist() == want.tolist() == [PG._wrap32(closed)]


@pytest.mark.parametrize("unified", [True, False])
@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("n", [0, 1, 17])
def test_ladder_kernels_at_small_sizes(dev, n, stage, unified):
    args, kw = PG.ladder_inputs(n, max(n, 1), 10, n + 1, unified=unified,
                                stage=stage)
    kernel = PG.gs_ladder_uni if unified else PG.gs_ladder
    x = PG.to_device(args, dev)
    got, want = kernel(*x, **kw), kernel.plain(*x, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert got[-2].tolist() == [n, 0]


@pytest.mark.parametrize("first", ["mod", "three"])
@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("unified,warps", [(True, 1), (True, 2), (True, 4),
                                           (True, 8), (False, None)])
def test_ladder_kernels_on_conflict_instances(dev, monkeypatch, unified,
                                              warps, stage, first):
    """Repeated first columns (u mod 1024 over 20,000 rows; three queued
    rows on one column) at stage 3 run to max_bids = 60,000 with evictions
    on nearly every bid: kernel == plain version, P16 at every gather-warp
    count, P17 (three tables) at the default; the look-ahead kernel's
    counters add up to the bids."""
    if warps is not None:
        monkeypatch.setattr(PG, "GATHER_WARPS", warps)
    n = 20_000
    args, kw = PG.ladder_inputs(n, n, 10, n + 1, unified=unified,
                                stage=stage, max_bids=60_000, first=first,
                                first_mod=1024)
    kernel = PG.gs_ladder_uni if unified else PG.gs_ladder
    x = PG.to_device(args, dev)
    got, want = kernel(*x, **kw), kernel.plain(*x, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    bids = got[-2].tolist()[0]
    assert bids == (60_000 if stage == 3 else x[0][0])
    cnt = PG.ladder_counters(kernel)      # P16 and P17: one kernel
    assert cnt["from_lane"] + cnt["self"] == bids
    assert cnt["stale"] <= cnt["from_lane"]


@pytest.mark.parametrize("segment", [None, 128])
@pytest.mark.parametrize("n", [0, 1, 12, 64, 65, 96, 97, 130, 200, 1000,
                               20_000])
def test_store_kernel_matches_plain(dev, monkeypatch, n, segment):
    """P15's store passes (segments of 512, or 128 to merge records at
    small n) against its plain loop on the CPU, bit for bit, at n = 0 to
    200 where positions 64-95 read slots the loop wrote, and on a prefix
    of the scale instance (2**18 row pairs)."""
    if segment is not None:
        monkeypatch.setattr(PG, "STORE_SEGMENT", segment)
    pairs = 2 ** 18 if n == 20_000 else 128
    for seed in range(1 if n >= 1000 else 4):
        hbm, q = PG.to_device(PG.store_inputs(n, pairs, seed), dev)
        got = PG.qdma_store_via_dma((n,), hbm, q)
        want = PG.qdma_store_via_dma.plain((n,), hbm.cpu(), q.cpu())
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("name,n,pos", [("qdma_store_datadep", 65, 64),
                                        ("qdma_store_via_dma", 65, 64),
                                        ("qdma_store_bitcast", 101, 100)])
def test_queue_kernels_raise_at_a_written_bad_row_id(dev, name, n, pos):
    """The loop kernel (P13, P14) and P15's kernel stop at a row id their
    loop wrote outside the tables, report it, and the wrapper raises the
    plain version's ValueError; the card runs the probe again afterwards."""
    hbm = torch.zeros(16, PG.LINE, dtype=torch.int32)
    hbm[4, 0], hbm[5, 0] = 5, -10
    q = torch.zeros(1, PG.LINE, dtype=torch.int32)
    q[0, 0] = 2
    kernel = PG.PROBES[name]
    with pytest.raises(ValueError) as plain:
        kernel((n,), hbm, q)
    assert f"position {pos} " in str(plain.value)
    with pytest.raises(ValueError) as card:
        kernel((n,), hbm.to(dev), q.to(dev))
    assert str(card.value) == str(plain.value)
    got = kernel((pos,), hbm.to(dev), q.to(dev))
    want = kernel((pos,), hbm, q)
    torch.cuda.synchronize()
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


_PASS_PROBES = ("while_qtable_dma", "while_qtable_dma_store", "qdma_dual",
                "qdma_alias3", "qdma_alias2", "qdma_store_bitcast")


def _pass_kernel_against_plain(dev, name, n, inst):
    """The probe's kernel on ``inst`` (queue_inputs) against its plain loop
    on CPU copies: the same outputs bit for bit, or the same ValueError.
    True where both raised."""
    kernel = PG.PROBES[name]
    host = {k: torch.from_numpy(v) for k, v in inst.items()}
    card = {k: t.to(dev) for k, t in host.items()}
    before = kernel.launches
    try:
        want, err = kernel((n,), *PG.queue_tables(kernel, host)), None
    except ValueError as e:
        want, err = None, str(e)
    try:
        got = kernel((n,), *PG.queue_tables(kernel, card))
    except ValueError as e:
        assert str(e) == err
        return True
    assert err is None, err
    assert kernel.launches == before + 1
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    return False


@pytest.mark.parametrize("segment", [None, 64])
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 12, 31, 32, 33, 127, 128, 129,
                               513, 2000, 20_000])
@pytest.mark.parametrize("name", _PASS_PROBES)
def test_pass_kernel_matches_plain(dev, monkeypatch, name, n, segment):
    """The pass kernel (P7, P8, P10-P12, P14) on the CPU tests' drawn
    instances (queue_inputs over 128 row pairs; 2**14 at n = 20,000), in
    segments of 512 or 64: equal to the plain loop bit for bit, P14
    raising at position 100 past n = 100 as the plain loop does."""
    if segment is not None:
        monkeypatch.setattr(PG, "QUEUE_SEGMENT", segment)
    pairs = 2 ** 14 if n == 20_000 else 128
    inst = PG.queue_inputs(n, pairs, n)
    if name == "while_qtable_dma_store":
        inst["q"][:n] %= pairs - 80
    raised = _pass_kernel_against_plain(dev, name, n, inst)
    assert raised == (name == "qdma_store_bitcast" and n > 100)


@pytest.mark.parametrize("segment", [None, 64])
@pytest.mark.parametrize("positions", [(0,), (31,), (32,), (64,), (511,),
                                       (512,), (700, 600), (33, 599, 1)])
@pytest.mark.parametrize("name", _PASS_PROBES)
def test_pass_kernel_stops_at_the_first_bad_id(dev, monkeypatch, name,
                                               positions, segment):
    """Bad ids at pass and segment boundaries, one or more, n = 800: the
    kernel reports the first in position order and the wrapper raises the
    plain loop's ValueError."""
    if segment is not None:
        monkeypatch.setattr(PG, "QUEUE_SEGMENT", segment)
    inst = PG.queue_inputs(800, 128, 7)
    for j, p in enumerate(positions):
        inst["q"][p] = -1 - j if j % 2 == 0 else 128 + j
    assert _pass_kernel_against_plain(dev, name, 800, inst)


@pytest.mark.parametrize("k", [None, 1, 2, 3, 4])
@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_pass_kernel_p8_chains_below_four(dev, n, k):
    """P8 with n < 4 (ids chain through pushes) and a push past the tables
    at the k-th link (q[0] = 128 - 20 k): as the plain loop."""
    inst = PG.queue_inputs(n, 128, 11)
    inst["q"][:n] %= 48
    if k is not None:
        inst["q"][0] = 128 - 20 * k
    raised = _pass_kernel_against_plain(dev, "while_qtable_dma_store", n, inst)
    assert raised == (k is not None and k * n < n + 4)


@pytest.mark.parametrize("n", [0, 1, 8, 17, 1000, 20_000])
def test_p9_runs_the_pump_kernel(dev, n):
    """P9 launches P6's pump kernel: equal to its plain loop and to the
    closed form, distinct row values."""
    hbm = _distinct_rows(2 * n + 2, dev)
    before = PG.sem_2d_dynamic.launches
    got = PG.sem_2d_dynamic((n,), hbm)[0]
    want = PG.sem_2d_dynamic.plain((n,), hbm.cpu())[0]
    closed = (131 * 2 * PG.LINE * (n * (n - 1) // 2)
              + (PG.LINE * (PG.LINE - 1) // 2) * n)
    assert got.tolist() == want.tolist() == [PG._wrap32(closed)]
    assert PG.sem_2d_dynamic.launches == before + 1


@pytest.mark.parametrize("segment", [None, 128])
@pytest.mark.parametrize("n", [0, 1, 12, 64, 65, 96, 97, 200, 1000])
def test_p13_runs_the_store_kernel(dev, monkeypatch, n, segment):
    """P13 launches P15's store-pass kernel: queue and out equal to its
    plain loop, over 4 seeds, where positions 64-95 read slots the loop
    wrote."""
    if segment is not None:
        monkeypatch.setattr(PG, "STORE_SEGMENT", segment)
    for seed in range(4):
        hbm, q = PG.to_device(PG.store_inputs(n, 128, seed), dev)
        got = PG.qdma_store_datadep((n,), hbm, q)
        want = PG.qdma_store_datadep.plain((n,), hbm.cpu(), q.cpu())
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("kw", [dict(), dict(problem="max")])
def test_rectangular_hybrid_on_cuda_matches_cpu(dev, kw):
    n, m = 3000, 5000             # > threshold 4096 unplaced at the start
    loc, val = _rect_instance(n, m)
    out = []
    for device in ("cuda", "cpu"):
        bid_topk.launches = commit.launches = 0
        out.append(P.AuctionSolver(loc=loc, val=val, shape=(n, m),
                                   mode="hybrid", device=device,
                                   **kw).solve())
        if device == "cuda":
            assert bid_topk.launches == commit.launches == \
                out[0]["meta"]["its"] > 0
    g, c = out
    np.testing.assert_array_equal(g["sol"], c["sol"])
    np.testing.assert_array_equal(g["prices"], c["prices"])
    for k in ("its", "host_bids", "phases", "obj"):
        assert g["meta"][k] == c["meta"][k], k
    assert g["meta"]["soln_found"]


@pytest.mark.parametrize("shape,kw", [
    ((3000, 3000), dict()), ((3000, 3000), dict(keep_assignment=False)),
    ((1500, 2500), dict(max_iter=3000)),
])
def test_device_mode_on_cuda_matches_cpu(dev, shape, kw):
    """The rectangular case is capped: the full-width solve with dummies
    can spend its whole max_iter (50 n + 2000 rounds) there, so the state
    after the cap is compared."""
    n, m = shape
    loc, val = (_instance(n) if n == m else _rect_instance(n, m))
    g, c = (P.AuctionSolver(loc=loc, val=val, shape=shape, mode="device",
                            device=d, **kw).solve() for d in ("cuda", "cpu"))
    np.testing.assert_array_equal(g["sol"], c["sol"])
    np.testing.assert_array_equal(_bits(torch.from_numpy(g["prices"])),
                                  _bits(torch.from_numpy(c["prices"])))
    for k in ("its", "phases", "final_eps", "obj"):
        assert g["meta"][k] == c["meta"][k], k
    assert g["meta"]["mode"] == "device"
    assert g["meta"]["soln_found"] or g["meta"]["its"] == kw["max_iter"]


@pytest.mark.parametrize("kw", [dict(), dict(wide_rounds=True, theta=10.0)])
def test_hybrid_on_cuda_matches_cpu(dev, kw):
    """The device pass makes one ladder launch per phase and no standalone
    K1/K2 launch."""
    n = 5000
    loc, val = _instance(n)
    bid_topk.launches = commit.launches = ladder_phase.launches = 0
    g = P.AuctionSolver(loc=loc, val=val, shape=(n, n), mode="hybrid",
                        device="cuda", **kw).solve()
    assert bid_topk.launches == commit.launches == 0
    assert ladder_phase.launches == g["meta"]["phases"] > 0
    assert g["meta"]["its"] > g["meta"]["phases"]
    c = P.AuctionSolver(loc=loc, val=val, shape=(n, n), mode="hybrid",
                        device="cpu", **kw).solve()
    np.testing.assert_array_equal(g["sol"], c["sol"])
    np.testing.assert_array_equal(g["prices"].view(np.int32),
                                  c["prices"].view(np.int32))
    for k in ("its", "host_bids", "phases", "tier_rounds", "obj"):
        assert g["meta"][k] == c["meta"][k], k
    assert g["meta"]["soln_found"]


def _tiered_case(n, integer, seed=30, k=8, empty_every=0):
    """A square instance and its eps schedule, as the tiered solve takes
    them; with ``empty_every``, every such row loses all its entries
    (nvalid = 0)."""
    rng = np.random.default_rng(seed)
    rr = np.concatenate([np.repeat(np.arange(n), k), np.arange(n)])
    cc = np.concatenate([rng.integers(0, n, n * k), rng.permutation(n)])
    _, idx = np.unique(rr * n + cc, return_index=True)
    rr, cc = rr[idx], cc[idx]
    cost = rng.integers(1, 1000, rr.shape[0])
    val = cost if integer else (cost + rng.random(rr.shape[0])).astype(
        np.float32)
    keep = (rr % empty_every != 3) if empty_every else np.ones_like(rr, bool)
    prob = P.from_coo(np.stack([rr, cc], 1)[keep], val[keep], shape=(n, n))
    vmax_abs = float(np.abs(prob.vals[prob.valid]).max())
    tr = PA.make_transform("min", n, prob.vals.dtype, vmax_abs,
                           int_exact=prob.int_exact)
    e0, e_min, theta = PA.default_eps_schedule(
        prob.vals.dtype, vmax_abs, n, tr.scale, theta=5.0,
        int_exact=prob.int_exact)
    assert prob.vals.dtype == (np.int32 if integer else np.float32)
    return dict(prob=prob, vals_t=tr.apply(prob.vals), e0=e0, e_min=e_min,
                theta=theta, max_iter=PA.default_max_iter(n))


def _tiered(c, device, max_iter=None, **kw):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa
    prob = c["prob"]
    return PC.solve_ell_tiered(
        t(prob.cols), t(c["vals_t"]), t(prob.valid), t(prob.nvalid),
        t(np.zeros(prob.n, prob.vals.dtype)), c["e0"], c["e_min"],
        c["theta"], c["max_iter"] if max_iter is None else max_iter, **kw)


def _assert_tiered_equal(got, want):
    (gr, gs), (wr, ws) = got, want
    np.testing.assert_array_equal(gr.sigma.cpu().numpy(), wr.sigma.numpy())
    np.testing.assert_array_equal(_bits(gr.prices), _bits(wr.prices))
    np.testing.assert_array_equal(gs.owner.cpu().numpy(), ws.owner.numpy())
    assert (gr.rounds, gr.phases, gr.unassigned) == \
        (wr.rounds, wr.phases, wr.unassigned)
    assert gs.tier_rounds == ws.tier_rounds


def _ladder_on_both(c, **kw):
    """The tiered solve on the card (the ladder kernel, counted) and on
    the CPU (its plain version); asserts one launch per phase."""
    ladder_phase.launches = 0
    for k in ladder_phase.stats:
        ladder_phase.stats[k] = 0
    got = _tiered(c, "cuda", **kw)
    torch.cuda.synchronize()
    launches = ladder_phase.launches
    want = _tiered(c, "cpu", **kw)
    _assert_tiered_equal(got, want)
    init = kw.get("init_state")
    assert launches == got[0].phases - (init.phases if init else 0)
    return got, dict(ladder_phase.stats)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("trunc", [0, 16])
@pytest.mark.parametrize("integer", [True, False])
def test_ladder_kernel_matches_plain(dev, integer, trunc, wide):
    """n = 3000 crosses the one-block tail (1024 rows) in every phase; the
    fine ladder with its floor at trunc."""
    n = 3000
    c = _tiered_case(n, integer)
    (res, st), stats = _ladder_on_both(
        c, trunc=trunc, wide=wide,
        tiers=PC.default_tiers(n, fine=True, floor=trunc))
    assert stats["grid_rounds"] > 0 and stats["tail_rounds"] > 0
    if wide:
        assert st.tier_rounds[0] > res.phases
    if trunc == 0:
        assert res.unassigned == 0
    else:
        assert 0 < res.unassigned <= trunc


@pytest.mark.parametrize("integer", [True, False])
def test_ladder_kernel_resume_and_round_cap(dev, integer):
    """A resume from init_state (a CUDA-made state and its CPU copy), and
    a max_iter cap that ends a phase inside the ladder."""
    n = 3000
    c = _tiered_case(n, integer, seed=31)
    (part, st), _ = _ladder_on_both(c, trunc=16, max_phases=2)
    assert part.phases == 3
    cpu_st = PC.TieredState(prices=st.prices.cpu(), owner=st.owner.cpu(),
                            sigma=st.sigma.cpu(), eps=st.eps,
                            rounds=st.rounds, phases=st.phases,
                            tier_rounds=list(st.tier_rounds))
    got = _tiered(c, "cuda", trunc=16, init_state=st)
    want = _tiered(c, "cpu", trunc=16, init_state=cpu_st)
    _assert_tiered_equal(got, want)
    full = got[0].rounds
    cap = part.rounds + (full - part.rounds) // 2 + 1
    (res, _), _ = _ladder_on_both(c, max_iter=cap)
    assert res.rounds == cap


def test_ladder_kernel_rows_without_entries(dev):
    n = 3000
    c = _tiered_case(n, False, seed=32, empty_every=97)
    assert (c["prob"].nvalid == 0).sum() == 31
    (res, _), _ = _ladder_on_both(c)
    assert res.unassigned == 0
    assert (res.sigma.cpu().numpy()[c["prob"].nvalid == 0] == -1).all()


@pytest.mark.parametrize("integer", [True, False])
def test_ladder_kernel_crosses_the_tail_at_20k(dev, integer):
    n = 20_000
    c = _tiered_case(n, integer, seed=33)
    (res, _), stats = _ladder_on_both(
        c, trunc=256, tiers=PC.default_tiers(n, fine=True, floor=256))
    assert stats["grid_rounds"] > res.phases and stats["tail_rounds"] > 0


# ---- the batched solves: K1's batched entry, DK, and the solves on CUDA


def _dense_block(rng, B, n, m, dtype, dev):
    """[B, n, m] values (missing = the neg sentinel; rows with 0, 1 and 2
    entries; ties), prices, sigma, per-instance eps."""
    neg = neg_sentinel_np(dtype)
    mask = rng.random((B, n, m)) < 0.4
    mask[:, 0] = False
    mask[:, 1] = False
    mask[:, 1, 2] = True
    mask[:, 2] = False
    mask[:, 2, [0, m - 1]] = True
    if dtype == np.float32:
        vals = -(rng.random((B, n, m)) * 999 + 1).astype(np.float32)
        vals[:, 3::7] = -2.5 * rng.integers(1, 4, vals[:, 3::7].shape)
        prices = (rng.random((B, m)) * 300).astype(np.float32)
        eps = (rng.random(B) + 0.1).astype(np.float32)
        bigp = np.float32(1000.0)
    else:
        vals = -rng.integers(1, 6, (B, n, m)).astype(np.int32) * 7
        prices = rng.integers(0, 4, (B, m)).astype(np.int32) * 7
        eps = rng.integers(1, 4, B).astype(np.int32)
        bigp = np.int32(36)
    sigma = np.where(rng.random((B, n)) < 0.3, rng.integers(0, m, (B, n)),
                     -1).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    return (t(np.where(mask, vals, neg)), t(mask.sum(2).astype(np.int32)
                                           .ravel()),
            t(prices.ravel()), t(sigma.ravel()), t(eps), bigp)


@pytest.mark.parametrize("m", [256, 250])          # 16-byte loads, scalar
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_dense_bid_kernel_matches_plain(dev, dtype, m):
    rng = np.random.default_rng(40)
    B, n = 3, 300
    A, nvalid, prices, sigma, eps, bigp = _dense_block(rng, B, n, m, dtype,
                                                       dev)
    full = torch.arange(B * n, dtype=torch.int32, device=dev)
    part = torch.full((512,), B * n, dtype=torch.int32, device=dev)
    part[:400] = torch.from_numpy(np.sort(rng.choice(B * n, 400,
                                                     replace=False))
                                  .astype(np.int32)).to(dev)
    for ids in (full, part):
        dense_bid.launches = 0
        got = dense_bid(ids, A, nvalid, prices, sigma, eps, bigp,
                        with_v1=True)
        want = dense_bid_plain(ids, A, nvalid, prices, sigma, eps, bigp,
                               with_v1=True)
        torch.cuda.synchronize()
        assert dense_bid.launches == 1
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_bits(a), _bits(b))
        assert int((got[0] < B * m).sum()) > 0


@pytest.mark.parametrize("K", K_GRID)
@pytest.mark.parametrize("phase_start", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_batched_bid_kernel_matches_plain(dev, monkeypatch, dtype, phase_start,
                                          K):
    """K1's batched entry over three instances flattened (rows b n + r,
    columns b m + c), each with its own eps and bigp, for every row group
    it can run at this K; shuffled ids with dead slots among them."""
    rng = np.random.default_rng(41 + K)
    B, n = 3, 2000
    parts = [_state(rng, n, K, dtype, dev) for _ in range(B)]
    cat = lambda k: torch.cat([p_[k] for p_ in parts])  # noqa: E731
    off = lambda b: b * n  # noqa: E731
    cols = torch.cat([p_["cols"] + off(b) for b, p_ in enumerate(parts)])
    sigma = torch.cat([torch.where(p_["sigma"] >= 0, p_["sigma"] + off(b),
                                   -1) for b, p_ in enumerate(parts)])
    owner = torch.cat([torch.where(p_["owner"] >= 0, p_["owner"] + off(b),
                                   -1) for b, p_ in enumerate(parts)])
    tdt = torch.float32 if dtype == np.float32 else torch.int32
    eps = torch.tensor([p_["eps"] * (b + 1) for b, p_ in enumerate(parts)],
                       dtype=tdt, device=dev)
    bigp = torch.tensor([p_["bigp"] + b for b, p_ in enumerate(parts)],
                        dtype=tdt, device=dev)
    sig = sigma.cpu().numpy()
    nv = cat("nvalid").cpu().numpy()
    live = np.flatnonzero(((sig < 0) & (nv > 0))
                          | (phase_start & (sig >= 0)))
    ids = np.full(B * n, B * n, np.int32)
    ids[:live.shape[0]] = live
    ids = torch.from_numpy(rng.permutation(ids)).to(dev)

    def run(fn, vals_m, cols):
        s_, o_ = sigma.clone(), owner.clone()
        tgt, bid = fn(ids, cols, vals_m, cat("nvalid"), cat("prices"), s_,
                      o_, eps, bigp, n, phase_start=phase_start)
        return tgt, bid, s_, o_

    want = run(bid_topk_batched_plain, cat("vals_m"), cols)
    for c, v in _row_groups(monkeypatch, K, cols, cat("vals_m")):
        got = run(bid_topk_batched, v, c)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_bits(a), _bits(b))


def _batched_instances(B, n, seed, integer, k=12):
    rng = np.random.default_rng(seed)
    probs = []
    for _ in range(B):
        rr = np.concatenate([np.repeat(np.arange(n), k), np.arange(n)])
        cc = np.concatenate([rng.integers(0, n, n * k), rng.permutation(n)])
        _, idx = np.unique(rr * n + cc, return_index=True)
        val = (rng.integers(1, 1000, idx.shape[0]) if integer else
               (rng.random(idx.shape[0]) * 999 + 1).astype(np.float32))
        probs.append(P.from_coo(np.stack([rr[idx], cc[idx]], 1), val,
                                shape=(n, n), pad_to=k + 2))
    return PB.stack_problems(probs)


@pytest.mark.parametrize("integer", [True, False])
def test_batched_device_mode_on_cuda_matches_cpu(dev, integer):
    """mode='device' at B = 4, n = 256: one batched K1 and one K2 launch a
    round; sols, prices bits, rounds, phases as on the CPU."""
    prob = _batched_instances(4, 256, 42, integer)
    bid_topk_batched.launches = commit.launches = 0
    g = PB.auction_solve_batched(prob, mode="device", device="cuda")
    rounds = max(mt["its"] for mt in g[1])
    assert bid_topk_batched.launches == commit.launches == rounds > 0
    c = PB.auction_solve_batched(prob, mode="device", device="cpu")
    np.testing.assert_array_equal(g[0], c[0])
    for a, b in zip(g[1], c[1]):
        for k in ("its", "phases", "final_eps", "obj", "soln_found"):
            assert a[k] == b[k], k
    vmax = float(np.abs(prob.vals).max())
    tr = PA.make_transform("min", 256, prob.vals.dtype, vmax)
    e0, e_min, theta = PA.default_eps_schedule(prob.vals.dtype, vmax, 256,
                                               tr.scale)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (prob.cols, tr.apply(prob.vals), prob.valid, prob.nvalid,
             np.zeros((4, 256), prob.vals.dtype))]
    res = [PB.solve_ell_batched(*[a.to(d) for a in args], e0, e_min, theta,
                                PA.default_max_iter(256))
           for d in (dev, torch.device("cpu"))]
    np.testing.assert_array_equal(_bits(res[0].prices), _bits(res[1].prices))
    np.testing.assert_array_equal(res[0].sigma.cpu(), res[1].sigma)


def test_batched_auto_with_warm_prices_takes_cpu_on_cuda(dev):
    """The default mode on the card sends a warm-started batch to the
    native 'cpu' solver, as the reference's 'auto' does: no kernel runs,
    the metas are the 'cpu' path's and equal the CPU call's."""
    prob = _batched_instances(4, 256, 45, True)
    wp = (np.random.default_rng(46).random((4, 256)) * 50).astype(
        prob.vals.dtype)
    bid_topk_batched.launches = commit.launches = dense_bid.launches = 0
    g = PB.auction_solve_batched(prob, warm_prices=wp, device="cuda")
    assert bid_topk_batched.launches == commit.launches == \
        dense_bid.launches == 0
    c = PB.auction_solve_batched(prob, warm_prices=wp, device="cpu")
    np.testing.assert_array_equal(g[0], c[0])
    for a, b in zip(g[1], c[1]):
        assert a["mode"] == "cpu" and "host_bids" in a
        assert {k: v for k, v in a.items() if k != "time"} == \
            {k: v for k, v in b.items() if k != "time"}


@pytest.mark.parametrize("integer", [True, False])
def test_batched_dense_hybrid_on_cuda_matches_cpu(dev, integer):
    """mode='hybrid' at B = 4, n = 256 (trunc 8, so rounds run): one DK and
    one K2 launch a round, plus one DK launch per violator scan; sols,
    prices bits, its, phases, host bids as on the CPU."""
    prob = _batched_instances(4, 256, 43, integer)
    dense_bid.launches = commit.launches = 0
    g = PD.solve_batched_dense_hybrid(prob, trunc=8, return_prices=True,
                                      device="cuda")
    rounds = max(mt["its"] for mt in g[1])
    assert commit.launches == rounds > 0
    assert dense_bid.launches > rounds
    c = PD.solve_batched_dense_hybrid(prob, trunc=8, return_prices=True,
                                      device="cpu")
    np.testing.assert_array_equal(g[0], c[0])
    np.testing.assert_array_equal(g[2].view(np.int32), c[2].view(np.int32))
    for a, b in zip(g[1], c[1]):
        for k in ("its", "phases", "host_bids", "final_eps", "obj",
                  "soln_found"):
            assert a[k] == b[k], k
    assert all(mt["soln_found"] for mt in g[1])


def test_dense_engine_on_cuda_matches_cpu(dev):
    rng = np.random.default_rng(44)
    C = rng.integers(1, 1000, (300, 300))
    g = P.AuctionSolver(C, mode="hybrid", device="cuda")
    r1, r2 = g.solve(), g.solve()
    c = P.AuctionSolver(C, mode="hybrid", device="cpu").solve()
    for r in (r1, r2):
        assert r["meta"]["engine"] == "dense"
        np.testing.assert_array_equal(r["sol"], c["sol"])
        np.testing.assert_array_equal(r["prices"], c["prices"])
        for k in ("its", "phases", "host_bids", "obj", "soln_found"):
            assert r["meta"][k] == c["meta"][k], k


# ---------------------------------------------------------------------------
# The sharded round (K2's resolve launch alone) and the device HK seed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("C", [1, 3000, 131_072])
def test_resolve_kernel_matches_plain(dev, dtype, C):
    """K2's resolve launch alone (ops.commit.resolve): global row ids in
    any order, equal, +-0.0 and negative bids, 10% without a bid, heavy
    contention at C = 131,072 (a few hundred columns); folded twice into
    one table (the second call onto the first's keys), exact."""
    from sslap_tpu_torch.ops.commit import resolve, resolve_plain
    rng = np.random.default_rng(C)
    m = 4096 if C > 1 else 8
    ids = rng.permutation(10 * C + 7)[:C].astype(np.int32) + 123_456
    choices = (np.array([-1.5, -0.0, 0.0, 2.0, 7.0], np.float32)
               if dtype == np.float32 else np.array([-3, 0, 5, 9], np.int32))
    keys = {}
    for side, d in (("kernel", dev), ("plain", torch.device("cpu"))):
        keys[side] = torch.zeros(m, dtype=torch.int64, device=d)
    launches = resolve.launches
    for rep in range(2):
        tgt = rng.integers(0, min(m, 300 + 3 * rep), C).astype(np.int32)
        tgt[rng.random(C) < 0.1] = m
        bid = rng.choice(choices, C)
        for side, fn in (("kernel", resolve), ("plain", resolve_plain)):
            d = keys[side].device
            fn(*(torch.from_numpy(a).to(d) for a in (ids, tgt, bid)),
               keys[side])
    torch.cuda.synchronize()
    assert resolve.launches == launches + 2
    np.testing.assert_array_equal(keys["kernel"].cpu().numpy(),
                                  keys["plain"].numpy())


@pytest.mark.parametrize("case", ["square_f32", "rect_i32"])
def test_sharded_round_on_one_card_matches_cpu(dev, case, monkeypatch):
    """Three shards on one card ([cuda:0] * 3: K1, K2's resolve launch and
    the key-table max each round) against three CPU shards (K1's plain
    version, resolve_bids and the pmax/pmin combine) and one card shard:
    sol, prices bits, rounds and phases equal; every key table is all zero
    after the solve, and K1 and the resolve launched every round."""
    import importlib
    from sslap_tpu_torch import parallel as PP
    K2 = importlib.import_module("sslap_tpu_torch.ops.commit")
    n, m = (300, 300) if case == "square_f32" else (240, 300)
    rng = np.random.default_rng(31)
    rr = np.concatenate([np.repeat(np.arange(n), 6), np.arange(n)])
    cc = np.concatenate([rng.integers(0, m, n * 6), rng.permutation(m)[:n]])
    _, idx = np.unique(rr * m + cc, return_index=True)
    loc = np.stack([rr[idx], cc[idx]], 1)
    val = (rng.random(len(idx)) * 99 + 1).astype(np.float32) \
        if case == "square_f32" else rng.integers(1, 100, len(idx))
    tables = []
    resolve = K2.resolve

    def spy(ids, tgt, bid, keys):
        tables.append(keys)
        return resolve(ids, tgt, bid, keys)

    # the wrapper counts its launches on the module's name, now the spy
    monkeypatch.setattr(K2, "resolve", spy)
    kw = dict(loc=loc, val=val, shape=(n, m), max_iter=3000)
    bid_topk.launches = spy.launches = 0
    on_card = PP.auction_solve_sharded(mesh=PP.make_mesh([dev] * 3), **kw)
    torch.cuda.synchronize()
    rounds = on_card["meta"]["its"]
    assert bid_topk.launches == spy.launches == 3 * rounds > 0
    assert all(int(t.count_nonzero()) == 0 for t in tables)
    one = PP.auction_solve_sharded(mesh=PP.make_mesh([dev]), **kw)
    cpu = PP.auction_solve_sharded(
        mesh=PP.make_mesh([torch.device("cpu")] * 3), **kw)
    for other in (one, cpu):
        np.testing.assert_array_equal(on_card["sol"], other["sol"])
        np.testing.assert_array_equal(_bits(torch.from_numpy(
            on_card["prices"])), _bits(torch.from_numpy(other["prices"])))
        assert all(on_card["meta"][k] == other["meta"][k]
                   for k in ("its", "phases", "unassigned", "final_eps"))


def test_greedy_matching_on_cuda_matches_cpu(dev):
    """The device seed of the HK check on the card equals the CPU run bit
    for bit (matchings and rounds), and the seeded HK size the host's."""
    from sslap_tpu_torch import feasibility as PF
    from sslap_tpu_torch import feasibility_device as PFD
    rng = np.random.default_rng(8)
    for n, m, k in ((5000, 5200, 3), (20_000, 20_000, 2), (7, 9, 2)):
        rows = np.repeat(np.arange(n), k)
        key = np.unique(rows * m + rng.integers(0, m, n * k))
        prob = P.from_coo(np.stack([key // m, key % m], 1),
                          rng.integers(1, 9, len(key)), shape=(n, m))
        got = PFD.greedy_matching(prob, device=dev)
        r_gpu = PFD.greedy_matching_packed.rounds
        want = PFD.greedy_matching(prob, device="cpu")
        assert r_gpu == PFD.greedy_matching_packed.rounds
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert PF.hopcroft_karp(prob, device_seed=True, device=dev)[2] == \
            PF.hopcroft_karp(prob)[2]


def _commit_state(rng, n, m, n_local, row_offset, dtype, dev):
    """A shard's replicas and rows before a commit: a random matching of
    half the rows (owner and sigma consistent; owner also holds rows of
    other shards), random prices, and a combined key table whose winners
    are unassigned rows (the solvers' promise) with bids on ~70% of the
    columns, some below price + eps."""
    from sslap_tpu_torch.ops.commit import KEY_FLIP, _flipped_keys
    rows = rng.permutation(n)
    held = rows[: n // 2]
    owner = np.full(m, -1, np.int32)
    cols = rng.permutation(m)[: held.size]
    owner[cols] = held
    sigma = np.full(n, -1, np.int32)
    sigma[held] = cols
    free = rows[n // 2:]
    has = rng.random(m) < 0.7
    winner = np.full(m, 2 ** 31 - 1, np.int64)
    winner[has] = rng.choice(free, has.sum())
    if dtype == np.float32:
        prices = rng.random(m).astype(np.float32) * 10
        best = (prices + rng.normal(0.5, 1.0, m)).astype(np.float32)
        eps = np.float32(0.25)
    else:
        prices = rng.integers(0, 100, m).astype(np.int32)
        best = (prices + rng.integers(-3, 6, m)).astype(np.int32)
        eps = np.int32(2)
    # one winner a column and a row wins at most one column
    _, first = np.unique(winner, return_index=True)
    keep = np.zeros(m, bool)
    keep[first] = True
    has &= keep
    keys = torch.where(
        torch.from_numpy(has),
        _flipped_keys(torch.from_numpy(best),
                      torch.from_numpy(np.where(has, winner, 0))) ^ KEY_FLIP,
        0)
    sl = slice(row_offset, row_offset + n_local)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
            (keys.numpy(), prices, owner, sigma[sl])], eps


@pytest.mark.parametrize("guarded", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("shape", [(4000, 4000, 1), (6000, 7000, 3)])
def test_commit_keys_kernel_matches_plain(dev, dtype, guarded, shape):
    """The fused key commit (ops.commit.commit_keys) against its plain
    version, on one shard and on shard 1 of 3 (rows outside the shard
    left alone): prices bits, owner, sigma equal; both tables zeroed."""
    import importlib
    K2 = importlib.import_module("sslap_tpu_torch.ops.commit")
    n, m, shards = shape
    n_local = n // shards
    off = n_local if shards > 1 else 0
    out = {}
    for side, d in (("kernel", dev), ("plain", torch.device("cpu"))):
        state, eps = _commit_state(np.random.default_rng(n + guarded), n, m,
                                   n_local, off, dtype, d)
        launches = K2.commit_keys.launches
        K2.commit_keys(*state, row_offset=off, eps=eps if guarded else None)
        torch.cuda.synchronize()
        assert K2.commit_keys.launches == launches + (side == "kernel")
        out[side] = [t.cpu() for t in state]
    for a, b in zip(out["kernel"], out["plain"]):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert int(out["kernel"][0].count_nonzero()) == 0


@pytest.mark.parametrize("case", ["square_f32", "square_i32"])
def test_overlapped_solve_on_one_card_matches_cpu(dev, case):
    """The overlapped solve on three shards of one card (K1, K2's resolve
    launch into alternating key tables, their max, the guarded fused
    commit) against three CPU shards and one card shard: sol, prices bits,
    rounds and phases equal; K1, the resolve and the fused commit launch
    once a shard a round."""
    from sslap_tpu_torch import parallel as PP
    from sslap_tpu_torch.ops.commit import commit_keys, resolve
    n = 300
    rng = np.random.default_rng(32)
    rr = np.concatenate([np.repeat(np.arange(n), 6), np.arange(n)])
    cc = np.concatenate([rng.integers(0, n, n * 6), rng.permutation(n)])
    _, idx = np.unique(rr * n + cc, return_index=True)
    loc = np.stack([rr[idx], cc[idx]], 1)
    val = (rng.random(len(idx)) * 99 + 1).astype(np.float32) \
        if case == "square_f32" else rng.integers(1, 100, len(idx))
    kw = dict(loc=loc, val=val, shape=(n, n))
    bid_topk.launches = resolve.launches = commit_keys.launches = 0
    on_card = PP.auction_solve_overlapped(mesh=PP.make_mesh([dev] * 3), **kw)
    torch.cuda.synchronize()
    rounds = on_card["meta"]["its"]
    assert bid_topk.launches == resolve.launches == commit_keys.launches \
        == 3 * rounds > 0
    one = PP.auction_solve_overlapped(mesh=PP.make_mesh([dev]), **kw)
    cpu = PP.auction_solve_overlapped(
        mesh=PP.make_mesh([torch.device("cpu")] * 3), **kw)
    for other in (one, cpu):
        np.testing.assert_array_equal(on_card["sol"], other["sol"])
        np.testing.assert_array_equal(_bits(torch.from_numpy(
            on_card["prices"])), _bits(torch.from_numpy(other["prices"])))
        assert all(on_card["meta"][k] == other["meta"][k]
                   for k in ("its", "phases", "unassigned", "final_eps"))


def _gathered_state(rng, D, n_local, m, C, dtype):
    """The bids D shards all-gather in a compact exchange round of the
    sharded hybrid: per shard C slots of sorted unassigned rows (its own,
    as global ids; 1/8 pads = D * n_local, tgt = m), targets drawn from a
    quarter of the columns (contention and ties), and the replicas and
    every row's sigma of a random matching."""
    n = D * n_local
    owner = np.full(m, -1, np.int32)
    held = rng.choice(n, n // 3, replace=False)
    owner[rng.choice(m, held.size, replace=False)] = held
    sig = np.full(n, -1, np.int32)
    sig[owner[owner >= 0]] = np.flatnonzero(owner >= 0)
    live = C - C // 8
    ids, tgt = [], []
    for s in range(D):
        free = np.flatnonzero(sig[s * n_local:(s + 1) * n_local] < 0)
        ids.append(np.concatenate([np.sort(rng.choice(free, live, False))
                                   + s * n_local, [n] * (C - live)]))
        tgt.append(np.concatenate([rng.integers(0, m // 4, live),
                                   [m] * (C - live)]))
    if dtype == np.float32:
        bid = (rng.integers(0, 40, D * C) * 0.5).astype(np.float32)
        prices = (rng.integers(0, 10, m) * 0.5).astype(np.float32)
    else:
        bid = rng.integers(0, 40, D * C).astype(np.int32)
        prices = rng.integers(0, 10, m).astype(np.int32)
    return (np.concatenate(ids).astype(np.int32),
            np.concatenate(tgt).astype(np.int32), bid, prices, owner, sig)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("shard", [0, 2])
def test_gathered_commit_matches_plain(dev, dtype, shard):
    """K2 over a gathered set of 4 shards (ops.commit.commit with a row
    offset), as shard ``shard`` commits it, against its plain version:
    stay, evicted, counts, prices bits, owner and the shard's sigma equal;
    the key table zeroed; other shards' rows left alone."""
    import importlib
    K2 = importlib.import_module("sslap_tpu_torch.ops.commit")
    D, n_local, m, C = 4, 20_000, 60_000, 8192
    ids, tgt, bid, prices, owner, sig = _gathered_state(
        np.random.default_rng(shard), D, n_local, m, C, dtype)
    off = shard * n_local
    out = {}
    for side, d in (("kernel", dev), ("plain", torch.device("cpu"))):
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(d) for a in
             (ids, tgt, bid, prices, owner, sig[off:off + n_local])]
        keys = torch.zeros(m, dtype=torch.int64, device=d)
        launches = K2.commit.launches
        res = K2.commit(*t, keys, row_offset=off, n_rows=D * n_local)
        torch.cuda.synchronize()
        assert K2.commit.launches == launches + (side == "kernel")
        assert int(keys.count_nonzero()) == 0
        out[side] = [x.cpu() for x in (*res, *t[3:])]
    for a, b in zip(out["kernel"], out["plain"]):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    won, evicted, stayed = out["kernel"][2].tolist()
    assert won > 0 and evicted > 0 and stayed > 0


@pytest.mark.parametrize("shards", [1, 4])
def test_sharded_hybrid_on_one_card_matches_cpu(dev, shards):
    """The sharded hybrid on shards of one card (K1, the key-table rounds,
    and in the ladder the all-gathered triples through K2 with the shard's
    row offset) against the same solve on a CPU mesh of as many shards:
    sol, prices bits and the meta (its, phases, tier_rounds, host bids,
    objective, comm bytes) equal, plain and balanced (also on the
    reference's contested instance, whose balanced buffers overflow on 4
    shards: local rebuilds run); K2 launches once a shard a ladder round,
    K1 once a shard a round."""
    from sslap_tpu_torch import parallel as PP
    from sslap_tpu_torch.ops.commit import commit_keys, resolve
    n = 3000
    rng = np.random.default_rng(33)
    rr = np.concatenate([np.repeat(np.arange(n), 6), np.arange(n)])
    cc = np.concatenate([rng.integers(0, n, n * 6), rng.permutation(n)])
    _, idx = np.unique(rr * n + cc, return_index=True)
    loc = np.stack([rr[idx], cc[idx]], 1)
    val = (rng.random(len(idx)) * 99 + 1).astype(np.float32)
    # tests/utils.py's contested_instance(5000, 128): a dense 128 x 128
    # block on rows 0..127, the other rows diagonal
    nc, C = 5000, 128
    c_val = np.random.default_rng(0).integers(1, 100, C * C + nc - C)
    c_loc = np.stack([np.r_[np.repeat(np.arange(C), C), np.arange(C, nc)],
                      np.r_[np.tile(np.arange(C), C), np.arange(C, nc)]], 1)
    balanced = dict(trunc=32, ladder_balance=True, balance_floor=16)
    for kw in (dict(trunc=32, loc=loc, val=val, shape=(n, n)),
               dict(balanced, loc=loc, val=val, shape=(n, n)),
               dict(balanced, loc=c_loc, val=c_val.astype(np.float32),
                    shape=(nc, nc))):
        bid_topk.launches = commit.launches = 0
        resolve.launches = commit_keys.launches = 0
        card = PP.auction_solve_sharded_hybrid(
            mesh=PP.make_mesh([dev] * shards), **kw)
        torch.cuda.synchronize()
        mt = card["meta"]
        tr = mt["tier_rounds"]
        assert mt["soln_found"] and sum(tr[2:]) > 0
        assert bid_topk.launches == shards * mt["its"]
        assert commit.launches == shards * sum(tr[2:])
        assert resolve.launches == commit_keys.launches == \
            shards * (tr[0] + tr[1])
        cpu = PP.auction_solve_sharded_hybrid(
            mesh=PP.make_mesh([torch.device("cpu")] * shards), **kw)
        np.testing.assert_array_equal(card["sol"], cpu["sol"])
        np.testing.assert_array_equal(_bits(torch.from_numpy(
            card["prices"])), _bits(torch.from_numpy(cpu["prices"])))
        for k, v in cpu["meta"].items():
            if k not in ("time", "device_time", "host_gs_time"):
                assert mt[k] == v, k
        if kw["loc"] is c_loc and shards > 1:
            assert mt["ladder_rebuilds"] >= 1


@pytest.mark.parametrize("integer", [False, True])
def test_candidates_on_one_card_matches_cpu(dev, integer):
    """engine='candidates' on the card (the shortlist bid and rescan as
    torch ops, K2 over every joint set, K1 + K2 in the compact tiers)
    against the same solve on the CPU, n = 6000 (above the 4096 switch),
    modes 'hybrid' (trunc) and 'device' (complete): sol, prices bits and
    the meta equal; K2 launches once a round, K1 once a compact-tier
    round."""
    from sslap_tpu_torch import candidate as PCD
    n = 6000
    rng = np.random.default_rng(21)
    rr = np.concatenate([np.repeat(np.arange(n), 8), np.arange(n),
                         np.repeat(np.arange(n), 6)])
    cc = np.concatenate([rng.integers(0, n, n * 8), rng.permutation(n),
                         rng.integers(0, 256, 6 * n) * 7])
    _, idx = np.unique(rr * n + cc, return_index=True)
    rr, cc = rr[idx], cc[idx]
    step = rng.integers(0, 100, len(idx))
    cost = np.where((cc % 7 == 0) & (cc < 256 * 7), 0, 1000) + step
    val = cost if integer else (cost * 0.5).astype(np.float32)
    loc = np.stack([rr, cc], 1)
    tiers = PC.default_tiers(n)
    states = []
    real = PCD.solve_candidates

    def keep(*a, **kw):
        out = real(*a, **kw)
        states.append(out[1])
        return out

    PCD.solve_candidates = keep
    try:
        for mode in ("hybrid", "device"):
            bid_topk.launches = commit.launches = 0
            args = dict(loc=loc, val=val, shape=(n, n), mode=mode,
                        engine="candidates")
            card = P.AuctionSolver(**args, device="cuda").solve()
            torch.cuda.synchronize()
            k1, k2 = bid_topk.launches, commit.launches
            host = P.AuctionSolver(**args, device="cpu").solve()
            st, st_cpu = states[-2], states[-1]
            np.testing.assert_array_equal(card["sol"], host["sol"])
            np.testing.assert_array_equal(card["prices"].view(np.int32),
                                          host["prices"].view(np.int32))
            for k in ("its", "phases", "host_bids", "tier_rounds", "obj",
                      "final_eps", "soln_found"):
                assert card["meta"].get(k) == host["meta"].get(k), k
            assert st.tier_rounds == st_cpu.tier_rounds
            assert st.rescans == st_cpu.rescans
            compact = sum(r for r, C in zip(st.tier_rounds[1:], tiers)
                          if C <= PCD.SWITCH)
            assert sum(r for r, C in zip(st.tier_rounds[1:], tiers)
                       if C > PCD.SWITCH) > 0
            assert (k1, k2) == (compact, card["meta"]["its"])
            assert card["meta"]["soln_found"]
    finally:
        PCD.solve_candidates = real


@pytest.mark.parametrize("warm", ["fr", "relax"])
def test_tracking_chain_on_one_card_matches_cpu(dev, warm):
    """The tracking harness's chains (families A, C and B: chained warm
    prices, FR tightening, drift-matched eps_start, warm Hopcroft-Karp)
    on the card against the same chains with device='cpu', n = 5000, under
    the FR tightening and the 0.9 rollback: every
    frame's record (but its timers), sol, prices bits, rounds, phases and
    fell_back equal; on the hybrid path one ladder launch per phase and
    no standalone K1/K2 launch."""
    from sslap_tpu_torch.benchmarks import tracking as T
    runs = {}
    for device in ("cuda", "cpu"):
        details = []
        launches = []

        def on_frame(d):
            launches.append((ladder_phase.launches, bid_topk.launches,
                             commit.launches))
            ladder_phase.launches = bid_topk.launches = commit.launches = 0
            details.append(d)

        ladder_phase.launches = bid_topk.launches = commit.launches = 0
        records, _ = T.run_families(n=5000, frames=1, mode="hybrid",
                                    device=device, warm=warm,
                                    on_frame=on_frame)
        runs[device] = (records, details, launches)
    (rc, dc, lc), (rp, dp, _) = runs["cuda"], runs["cpu"]
    assert len(rc) == len(rp) == 14
    for a, b in zip(rc, rp):
        assert {k: v for k, v in a.items() if k not in ("s", "hk_s")} == \
            {k: v for k, v in b.items() if k not in ("s", "hk_s")}
    for a, b, (ladder, k1, k2) in zip(dc, dp, lc):
        np.testing.assert_array_equal(a["sol"], b["sol"])
        np.testing.assert_array_equal(a["prices"].view(np.int32),
                                      b["prices"].view(np.int32))
        for key in ("its", "phases", "soln_found"):
            assert [m[key] for m in a["metas"]] == \
                [m[key] for m in b["metas"]], key
        assert a["fell_back"] == b["fell_back"]
        assert a["metas"][-1]["soln_found"]
        assert ladder == sum(m["phases"] for m in a["metas"])
        assert (k1, k2) == (0, 0)


def test_fuzz_families_on_one_card_match_cpu(dev):
    """The differential fuzz (sslap_tpu_torch.benchmarks.fuzz) with
    --device cuda: 5 seeds of each family (seeds 115-139 in turn, whose
    auction cases take the dense engine, the ladder and the sharded
    rounds) pass the scipy oracles and equal their CPU twins call by call,
    bit for bit; K1, K2, the ladder, DK and the fused commit each launch."""
    from sslap_tpu_torch.benchmarks import fuzz as F
    cases = F.case_list(115, 25, "all")
    out = F.sweep(cases, "cuda", log=lambda *a: None)
    assert out["by_family"] == dict.fromkeys(F.PLANS, 5)
    assert not out["failures"], out["failures"]
    kernels = out["launches"]["kernels"]
    assert all(kernels[k] > 0 for k in F.KERNEL_COUNTERS), kernels
    assert out["unreached"] == []
