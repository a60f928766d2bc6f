"""Drive the PyTorch + CUDA port (``sslap_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device.  Phases, each
of which raises on failure (so the exit code is non-zero):

  1. device   -- a CUDA device must exist; prints its name and power limit
  2. build    -- compiles the hand-written kernels (ops/csrc/*.cu) with nvcc
  3. kernels  -- each kernel against its plain PyTorch twin on the card at
                 the main path's shapes (K = 10, n = m = 1M; C = 256, 3072
                 and 1M), float32 and int32, plus a tie-heavy resolve case.
                 Tolerance: exact (targets, winners, owner and sigma equal;
                 bids and prices bit for bit).  Times from CUDA events,
                 median of reps.
  4. parity   -- the port on CUDA against the port on the CPU at 20k x 20k
                 (identical solution, prices and round counts), and a
                 2k x 2k integer instance against scipy's optimum
  5. headline -- the 1M x 1M, ~10 nnz/row float32 instance (bench.py's
                 generator and seed) through AuctionSolver(mode="hybrid",
                 device="cuda"), cold and then cached, held against the
                 port's own mode="cpu" solve: |obj - obj_cpu| <= n * eps_min
  6. gs       -- K3 (ops.gs_auction_device) on the headline's tail: the
                 square hybrid's device pass is rebuilt from the package's
                 functions, owner derived, the unassigned rows with entries
                 queued ascending (the native engine's order).  K3 against
                 its twin for the first 20,000 bids (exact), then K3 and the
                 native forward auction_gs on that state to the end (or
                 both to one cap, if K3 would need more than 60 s): prices
                 bit for bit, owner and bid counts equal
  7. rect     -- the 100k x 200k, 10 nnz/row rectangular sweep row
                 (benchmarks/run_all.py:make_sparse, integer costs < 10,000,
                 seed 11) through mode="hybrid" on the card and mode="cpu".
                 Scaled by m + 1 these costs exceed the exact int32 range,
                 so ingest gives them float64, which only mode="cpu" takes
                 (as in the reference): the device solve runs them as
                 float32 and is held to the eps-optimality bound m *
                 eps_min against the exact mode="cpu" objective (equality
                 is reported)
  8. jacobi   -- CUDA against CPU, bit for bit: the rectangular hybrid at
                 10k x 20k (int32), mode="device" at 10k x 10k (float32)
                 and at 10k x 20k (int32, capped at 1,000 rounds: the
                 full-width rectangular solve can spend its whole
                 max_iter, 50 n + 2000 rounds, there)

The line before the last is {"kernels": [...]}: per kernel, the launches
counted on its path (K1, K2: the cold headline solve; K3: the tail run),
and its time and its twin's time (K1, K2: C = 1M, float32; K3: the first
20,000 bids of the tail).  The last line is {"ok": true, "device": {...}}.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from sslap_tpu_torch import AuctionSolver, _native
from sslap_tpu_torch import auction as A
from sslap_tpu_torch import compact as C
from sslap_tpu_torch.auction import neg_sentinel_np
from sslap_tpu_torch.ops import _build, bid_topk, bid_topk_plain, commit, \
    commit_plain, gs_auction_device, gs_auction_plain

N_HEAD = 1_000_000
K_HEAD = 10
NNZ_HEAD = 9_999_949          # bench.make_instance(1M, 1M, 9, seed=0)
DEVICE = "cuda"

KERNELS = {
    "bid_topk": {"route": "cuda",
                 "source": "sslap_tpu_torch/ops/csrc/bid.cu",
                 "replaces": "sslap_tpu/ops/bid.py:59"},
    "commit": {"route": "cuda",
               "source": "sslap_tpu_torch/ops/csrc/commit.cu",
               "replaces": "sslap_tpu/ops/commit.py:26"},
    "gs_auction_device": {"route": "cuda",
                          "source": "sslap_tpu_torch/ops/csrc/gs.cu",
                          "replaces": "sslap_tpu/ops/gs_kernel.py:64"},
}
GS_TWIN_BIDS = 20_000         # what the twin's per-bid Python loop runs
GS_MAX_SECONDS = 60.0         # above this, K3 and native stop at one cap


def log(*args) -> None:
    print(*args, flush=True)


def make_instance(n, m, k_extra, seed=0, low=1.0, high=1000.0):
    """Copy of bench.make_instance (bench.py imports jax): k_extra random
    columns per row plus a planted permutation, float32 costs."""
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


def make_sparse(n, m, nnz_per_row, seed=0, high=1000):
    """Copy of benchmarks/run_all.py:make_sparse with integer=True
    (benchmarks/ imports jax): nnz_per_row - 1 random columns per row plus
    a planted matching, deduplicated by the sorted fused key."""
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
    return loc, rng.integers(1, high, loc.shape[0])


# ---------------------------------------------------------------------------
# Phases 1-2
# ---------------------------------------------------------------------------


def phase_device() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    log(smi.stdout.strip())
    log(f"[1 device] {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load()
    log(f"[2 build] kernels loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc: {_build.build_seconds} s)")
    for line in (_build.build_log or "").splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("  ptxas:", line.strip())


# ---------------------------------------------------------------------------
# Phase 3: kernels against their twins
# ---------------------------------------------------------------------------


def _inputs(rng, n, m, K, dtype, dev):
    """Random solver state at the main path's widths: per row K distinct
    sorted columns of which the first nvalid are real (0 and 1 included),
    padding col 0 / value = neg sentinel; a random partial matching over
    real entries; random prices."""
    start = rng.integers(0, m, n)
    step = rng.integers(1, m // K, n)
    cols = np.sort((start[:, None] + np.arange(K)[None, :] * step[:, None])
                   % m, axis=1)
    nvalid = rng.integers(0, K + 1, n).astype(np.int32)
    valid = np.arange(K)[None, :] < nvalid[:, None]
    cols = np.where(valid, cols, 0).astype(np.int32)
    if dtype == np.float32:
        vals = -(rng.random((n, K)) * 999 + 1).astype(np.float32)
        prices = (rng.random(m) * 500).astype(np.float32)
        eps, bigp = np.float32(0.37), np.float32(1000.0)
    else:   # int32, scaled by (m + 1) as the exact integer path is
        vals = -(rng.integers(1, 60, (n, K)) * (m + 1)).astype(np.int32)
        prices = rng.integers(0, 30 * (m + 1), m).astype(np.int32)
        eps, bigp = np.int32(1001), np.int32(60 * (m + 1) + 1)
    vals_m = np.where(valid, vals, neg_sentinel_np(dtype))
    # partial matching: each biddable row proposes its first column, the
    # lowest proposer per column keeps it, then half are dropped
    rows = np.flatnonzero(nvalid > 0)
    _, first = np.unique(cols[rows, 0], return_index=True)
    keep = rows[first]
    keep = keep[rng.random(keep.shape[0]) < 0.5]
    sigma = np.full(n, -1, np.int32)
    owner = np.full(m, -1, np.int32)
    sigma[keep] = cols[keep, 0]
    owner[cols[keep, 0]] = keep
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    return dict(cols=t(cols), vals_m=t(vals_m), nvalid=t(nvalid),
                prices=t(prices), sigma=t(sigma), owner=t(owner),
                eps=eps, bigp=bigp, n=n, m=m)


def _ids(rng, st, C, dev):
    """The compacted id list of a round at capacity C (pad = n): at C = n
    the phase-start list, else a sorted sample of unassigned biddable
    rows filling ~80% of C."""
    n = st["n"]
    sigma = st["sigma"].cpu().numpy()
    nvalid = st["nvalid"].cpu().numpy()
    if C == n:
        live = np.flatnonzero(((sigma < 0) & (nvalid > 0)) | (sigma >= 0))
    else:
        pool = np.flatnonzero((sigma < 0) & (nvalid > 0))
        live = np.sort(rng.choice(pool, int(0.8 * C), replace=False))
    ids = np.full(C, n, np.int32)
    ids[:live.shape[0]] = live
    return torch.from_numpy(ids).to(dev)


def _same_bits(a, b) -> bool:
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def _median_ms(prepare, run, reps: int) -> float:
    """Median device time of run(*prepare()) over reps, CUDA events around
    the call only (inputs are prepared outside the timed window)."""
    for _ in range(2):
        run(*prepare())
    marks = []
    for _ in range(reps):
        args = prepare()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        run(*args)
        t1.record()
        marks.append((t0, t1))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in marks]))


def _check_pair(st, ids, phase_start, reps, keys):
    """K1 then K2 on one round's inputs, kernel vs twin; returns
    (errors, times) dicts keyed by kernel name."""
    mut = ("prices", "sigma", "owner")

    def fresh():
        return [st[k].clone() for k in mut]

    def k1(fn, prices, sigma, owner):
        return fn(ids, st["cols"], st["vals_m"], st["nvalid"], prices,
                  sigma, owner, st["eps"], st["bigp"],
                  phase_start=phase_start)

    got, want = fresh(), fresh()
    tk, bk = k1(bid_topk, *got)
    tt, bt = k1(bid_topk_plain, *want)
    torch.cuda.synchronize()
    if not (torch.equal(tk, tt) and _same_bits(bk, bt)
            and all(torch.equal(a, b) for a, b in zip(got, want))):
        raise AssertionError("bid_topk kernel differs from its twin")
    errs = {"bid_topk": _abs_err(bk, bt)}

    def k2(fn, prices, sigma, owner, **kw):
        return fn(ids, tk, bk, prices, owner, sigma, **kw)

    after1 = got
    got, want = [a.clone() for a in after1], [a.clone() for a in after1]
    out_k = k2(commit, *got, keys=keys)
    out_t = k2(commit_plain, *want)
    torch.cuda.synchronize()
    if not (all(torch.equal(a, b) for a, b in zip(out_k, out_t))
            and _same_bits(got[0], want[0])
            and torch.equal(got[1], want[1])
            and torch.equal(got[2], want[2])
            and int(keys.count_nonzero()) == 0):
        raise AssertionError("commit kernel differs from its twin")
    errs["commit"] = _abs_err(got[0], want[0])

    times = {}
    for name, fn in (("bid_topk", bid_topk), ("bid_topk_plain",
                                              bid_topk_plain)):
        times[name] = _median_ms(fresh, lambda p, s, o, fn=fn: k1(fn, p, s,
                                                                   o), reps)

    def fresh2():
        return [a.clone() for a in after1]
    times["commit"] = _median_ms(
        fresh2, lambda p, s, o: k2(commit, p, s, o, keys=keys), reps)
    times["commit_plain"] = _median_ms(
        fresh2, lambda p, s, o: k2(commit_plain, p, s, o), reps)
    return errs, times, int(out_k[2][0]), int((tk < st["m"]).sum())


def _check_ties(rng, st, dtype, keys, dev):
    """Resolve with many equal bids, +-0.0 and negative bids, onto a few
    columns some of which are owned: kernel vs twin, exact."""
    n, m = st["n"], st["m"]
    sigma = st["sigma"].cpu().numpy()
    pool = np.flatnonzero(sigma < 0)
    ids = np.sort(rng.choice(pool, 3072, replace=False)).astype(np.int32)
    owned = np.flatnonzero(st["owner"].cpu().numpy() >= 0)[:48]
    cols = np.concatenate([owned, rng.choice(m, 49, replace=False)])
    tgt = rng.choice(cols, ids.shape[0]).astype(np.int32)
    tgt[rng.random(ids.shape[0]) < 0.1] = m                   # no bid
    if dtype == np.float32:
        choices = np.array([-1.5, -0.0, 0.0, 2.0, 7.25], np.float32)
    else:
        choices = np.array([-3, 0, 5], np.int32)
    bid = rng.choice(choices, ids.shape[0])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    ids, tgt, bid = t(ids), t(tgt), t(bid)
    got = [st[k].clone() for k in ("prices", "owner", "sigma")]
    want = [a.clone() for a in got]
    out_k = commit(ids, tgt, bid, *got, keys=keys)
    out_t = commit_plain(ids, tgt, bid, *want)
    torch.cuda.synchronize()
    if not (all(torch.equal(a, b) for a, b in zip(out_k, out_t))
            and _same_bits(got[0], want[0])
            and torch.equal(got[1], want[1])
            and torch.equal(got[2], want[2])):
        raise AssertionError("commit kernel differs from its twin on ties")
    return int(out_k[2][0])


def phase_kernels(n=N_HEAD, K=K_HEAD, capacities=(256, 3072, N_HEAD),
                  seed=0):
    """Every kernel against its twin on the card; returns (max abs error
    per kernel, times at C = n float32)."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed)
    errs = {"bid_topk": 0.0, "commit": 0.0}
    headline = {}
    keys = torch.zeros(n, dtype=torch.int64, device=dev)
    for dtype in (np.float32, np.int32):
        st = _inputs(rng, n, n, K, dtype, dev)
        for C in capacities:
            ids = _ids(rng, st, C, dev)
            reps = 20 if C >= 100_000 else 200
            e, t, won, bids = _check_pair(st, ids, C == n, reps, keys)
            for k, v in e.items():
                errs[k] = max(errs[k], v)
            log(f"[3 kernels] {np.dtype(dtype).name} C={C} "
                f"phase_start={C == n}: {bids} bids, {won} won; "
                f"bid_topk {t['bid_topk']:.4f} ms (twin "
                f"{t['bid_topk_plain']:.4f} ms), commit {t['commit']:.4f} "
                f"ms (twin {t['commit_plain']:.4f} ms); exact")
            if C == n and dtype == np.float32:
                headline = t
        won = _check_ties(rng, st, dtype, keys, dev)
        log(f"[3 kernels] {np.dtype(dtype).name} ties/+-0/negative bids "
            f"C=3072: {won} won; exact")
    return errs, headline


# ---------------------------------------------------------------------------
# Phases 4-5: the solver
# ---------------------------------------------------------------------------


def _solve(loc, val, n, device, **kw):
    return AuctionSolver(loc=loc, val=val, shape=(n, n), mode="hybrid",
                         device=device, **kw).solve()


def phase_parity(n=20_000) -> None:
    rr, cc, vv = make_instance(n, n, 9, seed=1)
    loc = np.stack([rr, cc], 1)
    cases = (("float32", vv, {}),
             ("float32 wide_rounds theta=10", vv,
              dict(wide_rounds=True, theta=10.0)),
             ("int32", np.round(vv).astype(np.int64), {}))
    for name, val, kw in cases:
        g = _solve(loc, val, n, DEVICE, **kw)
        c = _solve(loc, val, n, "cpu", **kw)
        gm, cm = g["meta"], c["meta"]
        if not (np.array_equal(g["sol"], c["sol"])
                and np.array_equal(g["prices"].view(np.int32),
                                   c["prices"].view(np.int32))
                and all(gm[k] == cm[k] for k in ("its", "phases",
                                                 "host_bids",
                                                 "tier_rounds"))
                and gm["soln_found"]):
            raise AssertionError(f"port on CUDA != port on CPU ({name})")
        log(f"[4 parity] {n}x{n} {name}: CUDA == CPU (sol, prices bitwise, "
            f"its {gm['its']}, phases {gm['phases']}, host_bids "
            f"{gm['host_bids']}, tier_rounds[0] {gm['tier_rounds'][0]})")
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import min_weight_full_bipartite_matching
    n2 = 2000
    rr, cc, vv = make_instance(n2, n2, 9, seed=2)
    vi = np.round(vv).astype(np.int64)
    res = _solve(np.stack([rr, cc], 1), vi, n2, DEVICE)
    sp = csr_matrix((vi.astype(np.float64), (rr, cc)), shape=(n2, n2))
    r, c = min_weight_full_bipartite_matching(sp)
    want = int(round(float(sp[r, c].sum())))
    if res["meta"]["obj"] != want:
        raise AssertionError(f"{n2}x{n2} int objective {res['meta']['obj']} "
                             f"!= scipy {want}")
    log(f"[4 parity] {n2}x{n2} int32 on CUDA: objective {want} == scipy")


def phase_headline(n=N_HEAD):
    t0 = time.perf_counter()
    rr, cc, vv = make_instance(n, n, 9, seed=0)
    nnz = rr.shape[0]
    if n == N_HEAD and nnz != NNZ_HEAD:
        raise AssertionError(f"instance nnz {nnz} != {NNZ_HEAD}")
    loc = np.stack([rr, cc], 1)
    solver = AuctionSolver(loc=loc, val=vv, shape=(n, n), mode="hybrid",
                           device=DEVICE)
    log(f"[5 headline] {n}x{n}, nnz {nnz}: instance + ingest "
        f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()
    bid_topk.launches = 0
    commit.launches = 0
    t0 = time.perf_counter()
    cold = solver.solve()
    cold_s = time.perf_counter() - t0
    launches = {"bid_topk": bid_topk.launches, "commit": commit.launches}
    t0 = time.perf_counter()
    warm = solver.solve()
    warm_s = time.perf_counter() - t0
    for name, res, secs in (("cold", cold, cold_s), ("cached", warm,
                                                      warm_s)):
        m = res["meta"]
        log(f"[5 headline] {name}: {secs:.3f} s; device {m['device_time']:.3f}"
            f" s, readback {m['readback_time']:.4f} s, host GS "
            f"{m['host_gs_time']:.3f} s; its {m['its']} (device "
            f"{1e3 * m['device_time'] / m['its']:.4f} ms/round), "
            f"host_bids {m['host_bids']}, phases {m['phases']}, obj "
            f"{m['obj']!r}")
        log(f"[5 headline] {name} tier_rounds {m['tier_rounds']}")
    if not (cold["meta"]["soln_found"] and warm["meta"]["soln_found"]):
        raise AssertionError("headline solve found no solution")
    sol = cold["sol"]
    if np.unique(sol).shape[0] != n or sol.min() < 0:
        raise AssertionError("headline solution is not a permutation")
    if not (np.array_equal(sol, warm["sol"])
            and np.array_equal(cold["prices"].view(np.int32),
                               warm["prices"].view(np.int32))):
        raise AssertionError("cached re-solve differs from the cold solve")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    t0 = time.perf_counter()
    cpu = AuctionSolver(loc=loc, val=vv, shape=(n, n), mode="cpu",
                        cardinality_check=False).solve()
    cpu_s = time.perf_counter() - t0
    gap = abs(cold["meta"]["obj"] - cpu["meta"]["obj"])
    bound = n * cold["meta"]["final_eps"]
    log(f"[5 headline] port mode='cpu': {cpu_s:.3f} s, obj "
        f"{cpu['meta']['obj']!r}; |obj - obj_cpu| = {gap!r} <= n * eps_min "
        f"= {bound!r}: {gap <= bound}")
    if not (cpu["meta"]["soln_found"] and gap <= bound):
        raise AssertionError("headline objective disagrees with mode='cpu'")
    log(f"[5 headline] launches during the cold solve: {launches}")
    return launches, solver


# ---------------------------------------------------------------------------
# Phase 6: K3 on the headline's tail
# ---------------------------------------------------------------------------


def _events_ms(fn):
    """(result, ms) of one call, CUDA events around it."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def headline_device_pass(solver):
    """The square hybrid's device pass on the headline, as
    hybrid.solve_hybrid calls compact.solve_tiered (same schedule, ladder,
    trunc, wide loop; the solver's cached problem data): the state the host
    finisher starts from."""
    prob = solver.problem_spec
    cache = solver._device_cache
    cols_d, vals_d, nvalid_d = cache["ell"]
    indptr, indices, data = cache["csr"]
    n, m = prob.n, prob.m
    dtype = prob.vals.dtype
    vmax_abs = float(np.abs(prob.vals[prob.valid]).max())
    tr = A.make_transform("min", m, dtype, vmax_abs)
    e0, e_min, theta = A.default_eps_schedule(
        dtype, vmax_abs, m, tr.scale, theta=A.device_theta_default(n))
    bigp = (data.max() - data.min()) + 1.0
    trunc = min(256, max(n // 8, 1))
    res, _ = C.solve_tiered(
        cols_d, vals_d, nvalid_d, torch.zeros(m, device=cols_d.device),
        e0, e_min, theta, A.default_max_iter(n), bigp=bigp,
        tiers=C.default_tiers(n, fine=True, floor=trunc), trunc=trunc,
        theta_tail=np.float32(3.0), tail_phases=2,
        wide=cache.get("wide", False))
    return res, e_min, bigp, (indptr, indices, data), (cols_d, vals_d,
                                                       nvalid_d)


def phase_gs(solver, cold_its):
    """K3 against its twin, then K3 against the native forward GS, on the
    headline's tail state.  Returns (max abs error vs the twin, K3 ms and
    twin ms over the first GS_TWIN_BIDS bids, launches in the tail run)."""
    t0 = time.perf_counter()
    res, e_min, bigp, csr, (cols_d, vals_d, nvalid_d) = \
        headline_device_pass(solver)
    torch.cuda.synchronize()
    if res.rounds != cold_its:
        raise AssertionError(f"rebuilt device pass ran {res.rounds} rounds, "
                             f"the cold solve {cold_its}")
    n = res.sigma.shape[0]
    m = res.prices.shape[0]
    dev = res.sigma.device
    sigma, prices = res.sigma, res.prices
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    owner = torch.full((m,), -1, dtype=torch.int32, device=dev)
    assigned = sigma >= 0
    owner[sigma[assigned].long()] = rows[assigned]
    pending = rows[(sigma < 0) & (nvalid_d > 0)]          # ascending
    queue = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    queue[:pending.shape[0]] = pending
    eps = np.float32(e_min)
    state = (cols_d, vals_d, queue, pending.shape[0], prices, owner, eps,
             bigp)
    log(f"[6 gs] headline device pass rebuilt: {res.rounds} rounds, "
        f"{pending.shape[0]} rows queued, eps {eps!r}, bigp {bigp!r} "
        f"({time.perf_counter() - t0:.2f} s)")

    got, k3_ms = _events_ms(lambda: gs_auction_device(*state, GS_TWIN_BIDS))
    want, twin_ms = _events_ms(lambda: gs_auction_plain(*state,
                                                        GS_TWIN_BIDS))
    if not (_same_bits(got[0], want[0]) and all(
            torch.equal(a, b) for a, b in zip(got[1:], want[1:]))
            and int(got[3]) == GS_TWIN_BIDS):
        raise AssertionError("gs_auction_device differs from its twin")
    err = _abs_err(got[0], want[0])
    us_per_bid = 1e3 * k3_ms / GS_TWIN_BIDS
    log(f"[6 gs] first {GS_TWIN_BIDS} bids: K3 {k3_ms:.3f} ms "
        f"({us_per_bid:.3f} us/bid), twin {twin_ms:.3f} ms "
        f"({1e3 * twin_ms / GS_TWIN_BIDS:.3f} us/bid); exact")

    def native(max_bids):
        p = prices.cpu().numpy().copy()
        s = sigma.cpu().numpy().copy()
        o = owner.cpu().numpy().copy()
        t = time.perf_counter()
        bids = _native.auction_gs(*csr, p, s, o, e_min, bigp, 0, max_bids)
        return p, o, bids, time.perf_counter() - t

    budget = 100 * n + 10_000_000          # the hybrid's finisher budget
    p_nat, o_nat, nat_bids, nat_s = native(budget)
    if nat_bids < 0:
        raise AssertionError("native GS exhausted its budget on the tail")
    cap = budget
    if nat_bids * us_per_bid * 1e-6 > GS_MAX_SECONDS:
        cap = int(GS_MAX_SECONDS * 1e6 / us_per_bid)
        log(f"[6 gs] native ran {nat_bids} bids in {nat_s:.3f} s; K3 would "
            f"need ~{nat_bids * us_per_bid * 1e-6:.0f} s: both capped at "
            f"{cap} bids")
        p_nat, o_nat, nat_bids, nat_s = native(cap)
        nat_bids = cap if nat_bids == -1 else nat_bids
    gs_auction_device.launches = 0
    t = time.perf_counter()
    out, k3_full_ms = _events_ms(lambda: gs_auction_device(*state, cap))
    k3_s = time.perf_counter() - t
    launches = gs_auction_device.launches
    k3_bids, left = int(out[3]), int(out[4])
    if not (k3_bids == nat_bids and (left == 0) == (cap == budget)
            and np.array_equal(out[0].cpu().numpy().view(np.int32),
                               p_nat.view(np.int32))
            and np.array_equal(out[1].cpu().numpy(), o_nat)):
        raise AssertionError(f"K3 differs from the native GS on the tail "
                             f"(bids {k3_bids} vs {nat_bids}, left {left})")
    if launches != 1:
        raise AssertionError(f"K3 launched {launches} times on the tail")
    log(f"[6 gs] tail: K3 {k3_bids} bids in {k3_s:.3f} s (events "
        f"{k3_full_ms:.1f} ms, {1e3 * k3_full_ms / k3_bids:.3f} us/bid), "
        f"native forward GS {nat_s:.3f} s ({1e6 * nat_s / nat_bids:.3f} "
        f"us/bid); rows left {left}; prices bitwise, owner and bids equal")
    return err, k3_ms, twin_ms, launches


# ---------------------------------------------------------------------------
# Phases 7-8: the rectangular hybrid and the Jacobi device path
# ---------------------------------------------------------------------------


def _meta_line(m):
    return (f"its {m['its']}, host_bids {m.get('host_bids')}, phases "
            f"{m['phases']}, obj {m['obj']!r}, final_eps {m['final_eps']!r}")


def phase_rect(n=100_000, m=200_000):
    loc, val = make_sparse(n, m, 10, seed=11, high=10_000)
    kw = dict(loc=loc, val=val, shape=(n, m))
    bid_topk.launches = commit.launches = 0
    t0 = time.perf_counter()
    hy = AuctionSolver(mode="hybrid", device=DEVICE, dtype=np.float32,
                       **kw).solve()
    hy_s = time.perf_counter() - t0
    launches = (bid_topk.launches, commit.launches)
    log(f"[7 rect] {n}x{m}, nnz {loc.shape[0]}: hybrid on the card "
        f"(float32) {hy_s:.3f} s; {_meta_line(hy['meta'])}; launches "
        f"K1 {launches[0]}, K2 {launches[1]}")
    t0 = time.perf_counter()
    ex = AuctionSolver(mode="cpu", **kw).solve()
    ex_s = time.perf_counter() - t0
    log(f"[7 rect] mode='cpu' (exact, float64) {ex_s:.3f} s; "
        f"{_meta_line(ex['meta'])}")
    t0 = time.perf_counter()
    cf = AuctionSolver(mode="cpu", dtype=np.float32, **kw).solve()
    cf_s = time.perf_counter() - t0
    log(f"[7 rect] mode='cpu' (float32) {cf_s:.3f} s; "
        f"{_meta_line(cf['meta'])}")
    if not (hy["meta"]["soln_found"] and ex["meta"]["soln_found"]
            and cf["meta"]["soln_found"]):
        raise AssertionError("a rectangular solve found no solution")
    if min(launches) <= 0 or launches[0] != hy["meta"]["its"]:
        raise AssertionError(f"rect hybrid launches {launches}, its "
                             f"{hy['meta']['its']}")
    gap = abs(hy["meta"]["obj"] - ex["meta"]["obj"])
    bound = m * hy["meta"]["final_eps"]
    log(f"[7 rect] |obj_hybrid - obj_exact| = {gap!r} <= m * eps_min = "
        f"{bound!r}: {gap <= bound}; equal: {gap == 0}")
    if gap > bound:
        raise AssertionError("rectangular hybrid objective out of bound")


def _parity(name, loc, val, shape, **kw):
    bid_topk.launches = commit.launches = 0
    t0 = time.perf_counter()
    g = AuctionSolver(loc=loc, val=val, shape=shape, device=DEVICE,
                      **kw).solve()
    g_s = time.perf_counter() - t0
    launches = (bid_topk.launches, commit.launches)
    t0 = time.perf_counter()
    c = AuctionSolver(loc=loc, val=val, shape=shape, device="cpu",
                      **kw).solve()
    c_s = time.perf_counter() - t0
    gm, cm = g["meta"], c["meta"]
    if not (np.array_equal(g["sol"], c["sol"])
            and np.array_equal(g["prices"].view(np.int32),
                               c["prices"].view(np.int32))
            and all(gm.get(k) == cm.get(k) for k in (
                "its", "phases", "host_bids", "final_eps", "unassigned",
                "obj"))):
        raise AssertionError(f"port on CUDA != port on CPU ({name})")
    if min(launches) <= 0 or launches[0] != gm["its"]:
        raise AssertionError(f"{name}: launches {launches}, its {gm['its']}")
    log(f"[8 jacobi] {name}: CUDA {g_s:.3f} s == CPU {c_s:.3f} s (sol, "
        f"prices bitwise, {_meta_line(gm)}); launches K1 {launches[0]}, "
        f"K2 {launches[1]}")


def phase_jacobi():
    loc, val = make_sparse(10_000, 20_000, 10, seed=12, high=3000)
    _parity("rect hybrid 10000x20000 int32", loc, val, (10_000, 20_000),
            mode="hybrid")
    _parity("mode='device' 10000x20000 int32, max_iter 1000", loc, val,
            (10_000, 20_000), mode="device", max_iter=1000)
    rr, cc, vv = make_instance(10_000, 10_000, 9, seed=3)
    _parity("mode='device' 10000x10000 float32", np.stack([rr, cc], 1), vv,
            (10_000, 10_000), mode="device")


def main() -> None:
    phase_device()
    phase_build()
    errs, times = phase_kernels()
    phase_parity()
    launches, solver = phase_headline()
    name = "gs_auction_device"
    errs[name], times[name], times[name + "_plain"], launches[name] = \
        phase_gs(solver, solver.meta["its"])
    del solver
    phase_rect()
    phase_jacobi()
    kernels = [dict(name=name, **KERNELS[name], launches=launches[name],
                    max_abs_err=errs[name], ms=times[name],
                    plain_ms=times[name + "_plain"])
               for name in KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
