"""The port's kernel twins (sslap_tpu_torch.ops) against the JAX package's
Pallas kernels (interpret mode) and its XLA oracles, on the CPU.

K1 (``bid_topk``) is held against ``ops.bid.bid_topk_pallas`` and
``auction.compute_bids``, and a numpy mirror of its CUDA kernel's row
group (lanes of a warp splitting a row, merged by shuffles) against its
plain version; K2 (``commit``) against
``ops.commit.commit_scatter_pallas`` and ``auction.resolve_bids``.
Tolerance: exact -- targets and winners equal, bids and prices bit for bit.
The kernels themselves run only on a CUDA device (test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from sslap_tpu import auction as RA
from sslap_tpu.ops.bid import bid_topk_pallas
from sslap_tpu.ops.commit import commit_scatter_pallas
from sslap_tpu_torch import auction as PA
from sslap_tpu_torch.ops import _build, bid_topk, bid_topk_batched_plain, \
    bid_topk_plain, commit, commit_plain
from sslap_tpu_torch.ops.bid import LANE_SLOTS, row_group
from sslap_tpu_torch.ops.commit import bid_key_decode_np, bid_key_np

I32_MAX = 2 ** 31 - 1
ROW_GROUPS = (1, 2, 4, 8, 16, 32)     # the row groups csrc/bid.cu takes


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _problem(rng, n, m, K, dtype, empty_rows=True):
    """ELL rows with sorted unique valid columns (the ingest invariant),
    row 0 single-entry, deliberate value ties, a few empty rows."""
    cols = rng.integers(0, m, (n, K)).astype(np.int32)
    if dtype == np.float32:
        vals = (rng.integers(0, 40, (n, K)) * 2.5).astype(np.float32)
    else:
        vals = rng.integers(0, 40, (n, K)).astype(np.int32) * 7
    valid = rng.random((n, K)) < 0.7
    valid[:, 0] = True
    valid[0, 1:] = False                     # v2 = v1 - bigp branch
    for i in range(n):
        c = np.unique(cols[i][valid[i]])
        valid[i] = False
        valid[i, :len(c)] = True
        cols[i, :len(c)] = c
    if empty_rows:
        valid[[5, 17]] = False
    nvalid = valid.sum(1).astype(np.int32)
    if dtype == np.float32:
        prices = (rng.integers(0, 8, m) * 1.25).astype(np.float32)
        eps, bigp = np.float32(0.25), np.float32(101.0)
    else:
        prices = (rng.integers(0, 8, m) * 3).astype(np.int32)
        eps, bigp = np.int32(2), np.int32(281)
    return cols, vals, valid, nvalid, prices, eps, bigp


def _masked(vals, valid):
    return np.where(valid, vals, PA.neg_sentinel_np(vals.dtype))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("seed", [0, 1])
def test_bid_twin_matches_pallas_and_xla(seed, dtype):
    rng = np.random.default_rng(seed)
    n, m, K = 96, 128, 6
    cols, vals, valid, nvalid, prices, eps, bigp = _problem(rng, n, m, K,
                                                            dtype)
    sigma = np.full(n, -1, np.int32)   # compacted-round invariant
    t0, b0 = RA.compute_bids(jnp.asarray(cols), jnp.asarray(vals),
                             jnp.asarray(valid), jnp.asarray(nvalid),
                             jnp.asarray(prices), jnp.asarray(sigma),
                             jnp.asarray(eps), jnp.asarray(bigp))
    t1, b1 = bid_topk_pallas(jnp.asarray(cols), jnp.asarray(vals),
                             jnp.asarray(valid), jnp.asarray(nvalid),
                             jnp.asarray(prices), jnp.asarray(sigma),
                             jnp.asarray(eps), jnp.asarray(bigp), block=32,
                             interpret=True)
    owner = np.full(m, -1, np.int32)
    ids = np.arange(n, dtype=np.int32)
    tp, bp = bid_topk(_t(ids), _t(cols), _t(_masked(vals, valid)),
                      _t(nvalid), _t(prices), _t(sigma), _t(owner), eps, bigp)
    tp, bp = tp.numpy(), bp.numpy()
    np.testing.assert_array_equal(tp, np.asarray(t0))
    np.testing.assert_array_equal(tp, np.asarray(t1))
    assert (tp[nvalid == 0] == m).all()
    real = nvalid > 0      # a row with no entries has no meaningful bid
    np.testing.assert_array_equal(_bits(bp)[real], _bits(b0)[real])
    np.testing.assert_array_equal(_bits(bp)[real], _bits(b1)[real])
    # the full-width torch oracle is the same function
    tq, bq = PA.compute_bids(_t(cols), _t(vals), _t(valid), _t(nvalid),
                             _t(prices), _t(sigma), eps.item(), bigp.item())
    np.testing.assert_array_equal(tq.numpy(), np.asarray(t0))
    np.testing.assert_array_equal(_bits(bq.numpy())[real], _bits(b0)[real])


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_bid_twin_on_shuffled_padded_ids(dtype):
    """A compacted list in any order, with pads (= n) anywhere, gives each
    live slot its row's full-width result; pads give (m, 0)."""
    rng = np.random.default_rng(4)
    n, m, K = 200, 150, 8
    cols, vals, valid, nvalid, prices, eps, bigp = _problem(rng, n, m, K,
                                                            dtype)
    args = (_t(cols), _t(_masked(vals, valid)), _t(nvalid), _t(prices),
            torch.full((n,), -1, dtype=torch.int32),
            torch.full((m,), -1, dtype=torch.int32), eps, bigp)
    t_all, b_all = bid_topk_plain(torch.arange(n, dtype=torch.int32), *args)
    live = rng.permutation(n)[:130]
    ids = np.concatenate([live, np.full(70, n)]).astype(np.int32)
    ids = ids[rng.permutation(ids.shape[0])]
    tgt, bid = bid_topk_plain(_t(ids), *args)
    is_live = ids < n
    np.testing.assert_array_equal(tgt.numpy()[is_live],
                                  t_all.numpy()[ids[is_live]])
    np.testing.assert_array_equal(_bits(bid.numpy())[is_live],
                                  _bits(b_all.numpy())[ids[is_live]])
    assert (tgt.numpy()[~is_live] == m).all()
    assert (bid.numpy()[~is_live] == 0).all()


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_bid_twin_phase_start_frees_violators(dtype):
    """phase_start: the eps-CS violators of auction.unassign_violators are
    freed in place, and exactly the unassigned biddable rows plus the
    violators bid, with compute_bids' targets and bits."""
    rng = np.random.default_rng(6)
    n = m = 120
    K = 6
    cols, vals, valid, nvalid, prices, eps, bigp = _problem(rng, n, m, K,
                                                            dtype)
    # a matching over each row's LAST valid entry (often not its best)
    sigma = np.full(n, -1, np.int32)
    owner = np.full(m, -1, np.int32)
    for i in range(n):
        if nvalid[i] and rng.random() < 0.7:
            c = cols[i, nvalid[i] - 1]
            if owner[c] < 0:
                owner[c], sigma[i] = i, c
    o_ref, s_ref = RA.unassign_violators(
        jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(valid),
        jnp.asarray(prices), jnp.asarray(owner), jnp.asarray(sigma),
        jnp.asarray(eps), 0)
    viol = (sigma >= 0) & (np.asarray(s_ref) < 0)
    assert viol.any() and (~viol & (sigma >= 0)).any()
    t_ref, b_ref = RA.compute_bids(
        jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(valid),
        jnp.asarray(nvalid), jnp.asarray(prices), s_ref, jnp.asarray(eps),
        jnp.asarray(bigp))
    ids = np.where(((sigma < 0) & (nvalid > 0)) | (sigma >= 0),
                   np.arange(n), n).astype(np.int32)
    s_p, o_p = _t(sigma.copy()), _t(owner.copy())
    tgt, bid = bid_topk_plain(_t(ids), _t(cols), _t(_masked(vals, valid)),
                              _t(nvalid), _t(prices), s_p, o_p, eps, bigp,
                              phase_start=True)
    np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(o_p.numpy(), np.asarray(o_ref))
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(t_ref))
    bidding = tgt.numpy() < m
    np.testing.assert_array_equal(_bits(bid.numpy())[bidding],
                                  _bits(b_ref)[bidding])


def _lane_split_bids(ids, cols, vals_m, nvalid, prices, sigma, owner, eps,
                     bigp, G, V, phase_start, rows_per=None):
    """numpy mirror of csrc/bid.cu's row group (round.cuh: bid_lanes, then
    bid_finish): G lanes a row, lane g taking LANE_SLOTS slots a step, as
    units of V (unit g + q G: slots k0 + V (g + q G) + 0 .. V - 1), then
    the __shfl_xor_sync butterfly
    merge, simulated lane by lane in the dtype's own scalar arithmetic.
    eps and bigp are scalars, or [B] arrays read at id // rows_per (the
    batched entry).  sigma and owner are updated in place; returns (tgt,
    bid)."""
    dt = vals_m.dtype.type
    n, K = cols.shape
    m = prices.shape[0]
    neg = PA.neg_sentinel_np(vals_m.dtype)[()]
    hneg = dt(PA.half_neg(vals_m.dtype))
    low = dt(-np.inf) if dt == np.float32 else dt(np.iinfo(np.int32).min)
    tgt = np.full(ids.shape[0], m, np.int32)
    bid = np.zeros(ids.shape[0], dt)
    for i, rid in enumerate(ids):
        if rid >= n:
            continue
        sig = sigma[rid] if phase_start else -1
        lanes = []
        for g in range(G):
            r = dict(v1=low, v2=neg, a=dt(0), cur=dt(0), slot=K, col=0)
            for k0 in range(0, K, LANE_SLOTS * G):
                for u in range(LANE_SLOTS):
                    k = k0 + V * (g + (u // V) * G) + u % V
                    if k >= K:
                        break
                    c, v = cols[rid, k], vals_m[rid, k]
                    w = dt(v - prices[c])
                    if r["slot"] == K:
                        r.update(v1=w, slot=k, a=v, col=c)
                    elif w > r["v1"]:
                        r.update(v2=r["v1"] if r["v1"] > r["v2"] else r["v2"],
                                 v1=w, slot=k, a=v, col=c)
                    else:
                        r["v2"] = w if w > r["v2"] else r["v2"]
                    if c == sig and w > hneg:
                        r["cur"] = dt(r["cur"] + w)
            lanes.append(r)
        off = G // 2
        while off:
            merged = []
            for g in range(G):
                me, o = lanes[g], lanes[g ^ off]
                take = o["v1"] > me["v1"] or (o["v1"] == me["v1"]
                                              and o["slot"] < me["slot"])
                win, lose = (o, me) if take else (me, o)
                merged.append(dict(
                    win, v2=lose["v1"] if lose["v1"] > win["v2"] else win["v2"],
                    cur=dt(me["cur"] + o["cur"])))
            lanes, off = merged, off // 2
        r = lanes[0]
        e, bp = eps, bigp
        if rows_per is not None:
            e, bp = eps[rid // rows_per], bigp[rid // rows_per]
        nv = nvalid[rid]
        v2 = dt(r["v1"] - bp) if nv < 2 else r["v2"]
        bidding = nv > 0
        if phase_start:
            viol = sig >= 0 and r["cur"] < dt(r["v1"] - e)
            if viol:
                owner[sig] = -1
                sigma[rid] = -1
            bidding = bidding and (sig < 0 or viol)
        bid[i] = dt(dt(dt(r["a"] + dt(0)) - v2) + e)
        tgt[i] = r["col"] if bidding else m
    return tgt, bid


def _lane_case(rng, K, dtype, mode, n=48, m=80):
    """Rows of K slots (first nvalid real, sorted distinct columns; padding
    col 0 at the neg sentinel), nv = 0, 1, 2 among them, values and prices
    from small sets (equal w at several slots, -0.0 and +0.0), and for
    the phase-start modes a matching over real entries: at random ones
    ('start_viol', violators among them) or at each row's first best
    column ('start_clean', none)."""
    nvalid = rng.integers(0, K + 1, n).astype(np.int32)
    nvalid[:3] = np.minimum([0, 1, 2], K)
    cols = np.zeros((n, K), np.int32)
    for r in range(n):
        cols[r, :nvalid[r]] = np.sort(rng.choice(m, nvalid[r], replace=False))
    if dtype == np.float32:
        vals = rng.choice(np.array([-0.0, 0.0, 2.5, 5.0, -2.5], np.float32),
                          (n, K))
        prices = rng.choice(np.array([0.0, 0.0, 2.5, 5.0], np.float32), m)
        eps, bigp = np.float32(0.75), np.float32(11.0)
    else:
        vals = rng.choice(np.array([0, 3, 6, -3], np.int32), (n, K))
        prices = rng.choice(np.array([0, 0, 3, 6], np.int32), m)
        eps, bigp = np.int32(2), np.int32(13)
    valid = np.arange(K) < nvalid[:, None]
    vals_m = np.where(valid, vals, PA.neg_sentinel_np(dtype)).astype(dtype)
    sigma = np.full(n, -1, np.int32)
    owner = np.full(m, -1, np.int32)
    for r in rng.permutation(n):
        if mode == "round" or nvalid[r] == 0 or rng.random() < 0.3:
            continue
        w = vals_m[r, :nvalid[r]] - prices[cols[r, :nvalid[r]]]
        k = int(np.argmax(w)) if mode == "start_clean" else \
            int(rng.integers(nvalid[r]))
        if owner[cols[r, k]] < 0:
            owner[cols[r, k]], sigma[r] = r, cols[r, k]
    return cols, vals_m, nvalid, prices, sigma, owner, eps, bigp


@pytest.mark.parametrize("mode", ["round", "start_viol", "start_clean"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("K", [1, 2, 3, 5, 10, 17, 52, 64])
def test_lane_split_merge_matches_plain(K, dtype, mode):
    """K1's row group (csrc/bid.cu), mirrored in numpy for every lane count
    G the kernel takes and both load widths, bit for bit against
    bid_topk_plain and bid_topk_batched_plain: targets, bids, and the
    violators freed in sigma and owner."""
    rng = np.random.default_rng(K * 10 + ["round", "start_viol",
                                          "start_clean"].index(mode))
    cols, vals_m, nvalid, prices, sigma, owner, eps, bigp = _lane_case(
        rng, K, dtype, mode)
    n = cols.shape[0]
    phase_start = mode != "round"
    live = np.arange(n) if phase_start else \
        np.flatnonzero((sigma < 0) & (nvalid > 0))
    ids = rng.permutation(np.concatenate([live, np.full(9, n)])) \
        .astype(np.int32)
    s0, o0 = _t(sigma), _t(owner)
    want = bid_topk_plain(_t(ids), _t(cols), _t(vals_m), _t(nvalid),
                          _t(prices), s0, o0, eps, bigp,
                          phase_start=phase_start)
    freed = int((s0.numpy() != sigma).sum())
    # one slot a row leaves no better column to violate for
    assert (freed > 0) == (mode == "start_viol" and K > 1)
    # batched: two instances of n / 2 rows, each with its own eps and bigp
    eps_of = np.array([eps, eps * 2], dtype)
    bigp_of = np.array([bigp, bigp + 1], dtype)
    s1, o1 = _t(sigma), _t(owner)
    want_b = bid_topk_batched_plain(_t(ids), _t(cols), _t(vals_m),
                                    _t(nvalid), _t(prices), s1, o1,
                                    _t(eps_of), _t(bigp_of), n // 2,
                                    phase_start=phase_start)
    vecs = (1, 4) if K % 4 == 0 else (1,)
    G0, V0 = row_group(K, _t(cols), _t(vals_m))        # the launcher's pick
    assert G0 in ROW_GROUPS and V0 in vecs and \
        LANE_SLOTS * G0 >= min(K, 32 * LANE_SLOTS)
    for G in ROW_GROUPS:
        for V in vecs:
            for (tw, bw), s_w, o_w, kw in (
                    (want, s0, o0, {}),
                    (want_b, s1, o1, dict(eps=eps_of, bigp=bigp_of,
                                          rows_per=n // 2))):
                s, o = sigma.copy(), owner.copy()
                args = dict(eps=eps, bigp=bigp)
                args.update(kw)
                tgt, bid = _lane_split_bids(ids, cols, vals_m, nvalid,
                                            prices, s, o, G=G, V=V,
                                            phase_start=phase_start, **args)
                np.testing.assert_array_equal(tgt, tw.numpy())
                np.testing.assert_array_equal(_bits(bid), _bits(bw.numpy()))
                np.testing.assert_array_equal(s, s_w.numpy())
                np.testing.assert_array_equal(o, o_w.numpy())


def _resolve_case(rng, dtype, nb=200, m=40):
    ids = np.sort(rng.choice(10_000, nb, replace=False)).astype(np.int32)
    ids = ids[rng.permutation(nb)]                # any order
    tgt = rng.integers(0, m + 1, nb).astype(np.int32)   # m = no bid
    if dtype == np.float32:
        bid = rng.choice(np.array([-7.5, -1.25, -0.0, 0.0, 3.0, 1e6],
                                  np.float32), nb)
    else:
        bid = rng.choice(np.array([-9, -2, 0, 4, 1 << 24], np.int32), nb)
    return ids, tgt, bid


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_commit_twin_matches_pallas_and_xla(seed, dtype):
    """Ties, equal +-0.0 bids and negative bids: the installed owner of
    every bid-on column is the reference's winner, its price the winner's
    own bid bits; the previous owner is evicted; losers stay."""
    rng = np.random.default_rng(seed)
    m = 40
    n = 10_000
    ids, tgt, bid = _resolve_case(rng, dtype, m=m)
    _, w_ref = RA.resolve_bids(jnp.asarray(tgt), jnp.asarray(bid), m,
                               jnp.asarray(ids))
    _, w_pal = commit_scatter_pallas(jnp.asarray(tgt), jnp.asarray(bid),
                                     jnp.asarray(ids), m, interpret=True)
    w_ref = np.asarray(w_ref)
    np.testing.assert_array_equal(w_ref, np.asarray(w_pal))
    # previous owners: rows outside ids, assigned to some of the columns
    sigma = np.full(n, -1, np.int32)
    owner = np.full(m, -1, np.int32)
    outside = np.setdiff1d(np.arange(n), ids)[:m]
    for j in range(0, m, 2):
        owner[j], sigma[outside[j]] = outside[j], j
    prices = np.arange(m).astype(dtype)
    p, o, s = _t(prices.copy()), _t(owner.copy()), _t(sigma.copy())
    stay, evicted, counts = commit(_t(ids), _t(tgt), _t(bid), p, o, s)
    won_cols = np.flatnonzero(w_ref != I32_MAX)
    pos = {r: i for i, r in enumerate(ids)}
    np.testing.assert_array_equal(o.numpy()[won_cols], w_ref[won_cols])
    win_bids = np.array([bid[pos[w]] for w in w_ref[won_cols]], dtype)
    np.testing.assert_array_equal(_bits(p.numpy()[won_cols]),
                                  _bits(win_bids))
    rest = np.setdiff1d(np.arange(m), won_cols)
    np.testing.assert_array_equal(o.numpy()[rest], owner[rest])
    np.testing.assert_array_equal(_bits(p.numpy()[rest]),
                                  _bits(prices[rest]))
    np.testing.assert_array_equal(s.numpy()[w_ref[won_cols]], won_cols)
    prev = owner[won_cols]
    prev = prev[prev >= 0]
    assert (s.numpy()[prev] == -1).all()
    np.testing.assert_array_equal(np.sort(evicted.numpy()[evicted < n]),
                                  np.sort(prev))
    lost = (tgt < m) & ~np.isin(ids, w_ref[won_cols])
    np.testing.assert_array_equal(stay.numpy(), np.where(lost, ids, n))
    assert counts.tolist() == [len(won_cols), len(prev), int(lost.sum())]
    # the port's resolve_bids is the reference's
    best_p, w_p = PA.resolve_bids(_t(tgt), _t(bid), m, _t(ids))
    best_r, _ = RA.resolve_bids(jnp.asarray(tgt), jnp.asarray(bid), m,
                                jnp.asarray(ids))
    np.testing.assert_array_equal(w_p.numpy(), w_ref)
    np.testing.assert_array_equal(best_p.numpy(), np.asarray(best_r))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_commit_bids_matches_reference(dtype):
    rng = np.random.default_rng(8)
    n = m = 64
    ids = np.arange(n, dtype=np.int32)
    tgt = rng.integers(0, m + 1, n).astype(np.int32)
    bid = (rng.integers(0, 5, n) * 3).astype(dtype)
    best, winner = RA.resolve_bids(jnp.asarray(tgt), jnp.asarray(bid), m,
                                   jnp.asarray(ids))
    prices = rng.integers(0, 3, m).astype(dtype)
    owner = np.where(rng.random(m) < 0.5, rng.permutation(n)[:m],
                     -1).astype(np.int32)
    sigma = np.full(n, -1, np.int32)
    sigma[owner[owner >= 0]] = np.flatnonzero(owner >= 0)
    ref = RA.commit_bids(best, winner, jnp.asarray(prices),
                         jnp.asarray(owner), jnp.asarray(sigma), 0)
    got = PA.commit_bids(_t(np.asarray(best)), _t(np.asarray(winner)),
                         _t(prices), _t(owner), _t(sigma))
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


_F32 = st.floats(width=32, allow_nan=False, allow_infinity=False)
_I32 = st.integers(-2 ** 31, 2 ** 31 - 1)
_ROW = st.integers(0, 2 ** 31 - 2)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_bid_key_orders_like_bid_then_lower_row(dtype):
    """The resolve key of csrc/commit.cu: larger key <=> higher bid, or an
    equal bid (-0.0 == +0.0) from a lower row; it decodes back."""
    values = _F32 if dtype == np.float32 else _I32

    @settings(max_examples=300, deadline=None)
    @given(values, _ROW, values, _ROW)
    def check(b1, r1, b2, r2):
        b = np.array([b1, b2], dtype)
        r = np.array([r1, r2])
        k1, k2 = bid_key_np(b, r)
        assert (k1 > k2) == bool((b[0] > b[1]) or (b[0] == b[1] and r1 < r2))
        assert (k1 == k2) == bool(b[0] == b[1] and r1 == r2)
        back, rows = bid_key_decode_np(np.array([k1, k2]), dtype)
        np.testing.assert_array_equal(rows, r)
        np.testing.assert_array_equal(_bits(back), _bits(b + dtype(0)))

    check()


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device raises; no
    wrapper runs its twin for anything but a CPU tensor."""
    ids = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        bid_topk(ids, None, None, None, None, None, None, 0.0, 1.0)
    with pytest.raises(RuntimeError, match="unsupported device"):
        commit(ids, None, None, None, None, None)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """The CUDA path never falls back: with no nvcc the build raises."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    try:
        _build._nvcc()
    except RuntimeError:
        pass
    else:
        pytest.skip("nvcc is installed on this host")
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_BUILD", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()
