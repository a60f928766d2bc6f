"""The port's CUDA kernels on a card: each against its plain PyTorch twin,
and the whole hybrid solve on CUDA against the same solve on the CPU.

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
from sslap_tpu_torch.auction import neg_sentinel_np
from sslap_tpu_torch.ops import bid_topk, bid_topk_plain, commit, \
    commit_plain

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
