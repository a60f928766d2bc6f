"""The port's CUDA kernels on a card: each against its plain PyTorch twin
(K3 also against the native Gauss-Seidel engine, with and without its
prefetch), the GS micro-probe kernels (P1-P17) against their plain
versions, and the hybrid (square and rectangular) and device-mode solves
on CUDA against the same solves on the CPU.

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
from sslap_tpu_torch import hybrid as PH
from sslap_tpu_torch.auction import neg_sentinel_np
from sslap_tpu_torch.ops import bid_topk, bid_topk_plain, commit, \
    commit_plain, gs_auction_device, gs_auction_plain
from sslap_tpu_torch.ops import probe_gs as PG

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


@pytest.mark.parametrize("phase_start", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_kernels_match_twins(dev, dtype, phase_start):
    rng = np.random.default_rng(11)
    n, K = 5000, 10
    st = _state(rng, n, K, dtype, dev)
    sig, nv = st["sigma"].cpu().numpy(), st["nvalid"].cpu().numpy()
    if phase_start:
        live = np.flatnonzero(((sig < 0) & (nv > 0)) | (sig >= 0))
    else:
        live = np.flatnonzero((sig < 0) & (nv > 0))[:3000]
    ids = np.full(4096 if not phase_start else n, n, np.int32)
    ids[:live.shape[0]] = live
    ids = torch.from_numpy(ids).to(dev)
    outs = []
    for k1, k2 in ((bid_topk, commit), (bid_topk_plain, commit_plain)):
        prices, sigma, owner = (st[k].clone() for k in
                                ("prices", "sigma", "owner"))
        tgt, bid = k1(ids, st["cols"], st["vals_m"], st["nvalid"], prices,
                      sigma, owner, st["eps"], st["bigp"],
                      phase_start=phase_start)
        stay, evicted, counts = k2(ids, tgt, bid, prices, owner, sigma)
        outs.append((tgt, bid, prices, sigma, owner, stay, evicted, counts))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert int(outs[0][7][0]) > 0


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_commit_kernel_matches_twin_on_ties(dev, dtype):
    """Equal, +-0.0 and negative bids onto a few columns, some owned."""
    rng = np.random.default_rng(12)
    n = 5000
    st = _state(rng, n, 10, dtype, dev)
    sig = st["sigma"].cpu().numpy()
    ids = np.sort(rng.choice(np.flatnonzero(sig < 0), 2000, replace=False))
    owned = np.flatnonzero(st["owner"].cpu().numpy() >= 0)[:20]
    cols = np.concatenate([owned, rng.choice(n, 20, replace=False)])
    tgt = rng.choice(cols, ids.shape[0]).astype(np.int32)
    tgt[rng.random(ids.shape[0]) < 0.1] = n
    choices = (np.array([-1.5, -0.0, 0.0, 2.0], np.float32)
               if dtype == np.float32 else np.array([-3, 0, 5], np.int32))
    bid = rng.choice(choices, ids.shape[0])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    ids, tgt, bid = t(ids.astype(np.int32)), t(tgt), t(bid)
    outs = []
    for fn in (commit, commit_plain):
        state = [st[k].clone() for k in ("prices", "owner", "sigma")]
        outs.append(list(fn(ids, tgt, bid, *state)) + state)
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        np.testing.assert_array_equal(_bits(a), _bits(b))


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


@pytest.mark.parametrize("n,k", [(3000, 8), (400, 60)])
def test_gs_kernel_matches_twin_and_native(dev, n, k):
    """K3 from a cold start: capped, against the twin (all five outputs);
    to the end, against the native forward GS (prices bit for bit).  K = 60
    puts two slots on some lanes."""
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
    assert int(got[3]) == 2 * n and int(got[4]) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    full = gs_auction_device(*args, 10 ** 9)
    prices = np.zeros(n, np.float32)
    sigma = np.full(n, -1, np.int32)
    owner = np.full(n, -1, np.int32)
    bids = _native.auction_gs(indptr, indices, data, prices, sigma, owner,
                              np.float32(0.5), bigp, 0, 10 ** 9)
    assert int(full[3]) == bids > n and int(full[4]) == 0
    np.testing.assert_array_equal(full[1].cpu().numpy(), owner)
    np.testing.assert_array_equal(_bits(full[0]), prices.view(np.int32))


@pytest.mark.parametrize("scan", ["full", "const", "noprices"])
def test_gs_kernel_prefetch_does_not_change_results(dev, scan):
    """K3 with and without its row prefetch: identical outputs, equal to
    the twin.  K = 40 puts two slots on some lanes; a 3-row ring wraps
    while it drains, so the prefetch of a just-pushed row runs."""
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
    n = 5000
    loc, val = _instance(n)
    bid_topk.launches = commit.launches = 0
    g = P.AuctionSolver(loc=loc, val=val, shape=(n, n), mode="hybrid",
                        device="cuda", **kw).solve()
    assert bid_topk.launches == commit.launches == g["meta"]["its"] > 0
    c = P.AuctionSolver(loc=loc, val=val, shape=(n, n), mode="hybrid",
                        device="cpu", **kw).solve()
    np.testing.assert_array_equal(g["sol"], c["sol"])
    np.testing.assert_array_equal(g["prices"].view(np.int32),
                                  c["prices"].view(np.int32))
    for k in ("its", "host_bids", "phases", "tier_rounds", "obj"):
        assert g["meta"][k] == c["meta"][k], k
    assert g["meta"]["soln_found"]
