"""Hopper counterparts of the GS micro-probes (P1-P17).

``benchmarks/probe_mosaic_gs.py`` isolates, one ``pallas_call`` each, the
TPU primitives K3 (``sslap_tpu/ops/gs_kernel.py``) is built from: async
row copies at dynamic offsets, scalar table reads and writes, queue-driven
copy loops with double buffering, aliased state tables, and K3 rebuilt in
stages.  Here each is a wrapper beside its plain PyTorch version:

    P1-P3   dma_hbm_dynrows, dma_vmem_dynoff2, dma_vmem_dynoff8
            -> csrc/probe_copy.cu   (cp.async.bulk + mbarrier)
    P4-P5   lane_read_write, lane_read_write_2d
            -> csrc/probe_lane.cu   (plain scalar accesses)
    P6-P15  while_double_buffer, while_qtable_dma, while_qtable_dma_store,
            sem_2d_dynamic, qdma_dual, qdma_alias3, qdma_alias2,
            qdma_store_datadep, qdma_store_bitcast, qdma_store_via_dma
            -> csrc/probe_queue.cu  (one loop kernel, a variant each)
    P16     gs_ladder_uni (probes gs_uni1-3)
    P17     gs_ladder (probes gs_ladder1-3)
            -> csrc/probe_ladder.cu (stage 1-3 x table layout)

and the probes ``gs_small``, ``gs_small_noprefetch``,
``gs_small_constscan`` and ``gs_small_noprices`` drive K3 itself
(``gs_auction_device(..., prefetch=, _scan=)``).  A wrapper takes the
probe's inputs (its scalar array first, as a sequence of ints or an int
tensor, then the tables as tensors) and returns what the Pallas call
returns, in its shapes and dtypes, aliased tables as new tensors; the
ladder kernels also return ``acc`` (f32 [1]).  CPU tensors run the plain
version, CUDA tensors launch the kernel or raise; ``.launches`` counts
launches.  The ladder kernels also take any n, m, K and cap
(``ladder_inputs``), so they run at the headline's scale.

    python -m sslap_tpu_torch.ops.probe_gs [name]

runs every probe (or one) on the card in the reference's order and
prints ``name: PASS`` after the reference's own asserts (``check``).  It
runs in-process and raises on the first failure: the reference's
subprocess per probe and liveness check guarded a relayed TPU that a bad
kernel could wedge; a CUDA fault raises in the caller instead (ROADMAP
drops ``utils/liveness.py`` for the same reason).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from sslap_tpu_torch.ops import _build
from sslap_tpu_torch.ops.gs_kernel import gs_auction_device, gs_auction_plain

LINE = 128
_QUEUE_VARIANTS = {"while_double_buffer": 6, "while_qtable_dma": 7,
                   "while_qtable_dma_store": 8, "sem_2d_dynamic": 9,
                   "qdma_dual": 10, "qdma_alias3": 11, "qdma_alias2": 12,
                   "qdma_store_datadep": 13, "qdma_store_bitcast": 14,
                   "qdma_store_via_dma": 15}


def _ints(s):
    return [int(v) for v in (s.tolist() if isinstance(s, torch.Tensor)
                             else s)]


def _wrap32(x: int) -> int:
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def _i32(*vals, device):
    return torch.tensor(vals, dtype=torch.int32, device=device)


def _need(cond, what):
    if not cond:
        raise ValueError(what)


def _table(t, dtype, name, aligned=False):
    """A contiguous table of the kernel's dtype (bulk copies also need a
    16-byte-aligned base)."""
    _need(t.dtype == dtype and t.is_contiguous(),
          f"{name}: need a contiguous {dtype} tensor, got {t.dtype}")
    _need(not aligned or t.data_ptr() % 16 == 0,
          f"{name}: needs a 16-byte-aligned base")
    return t


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


class ProbeKernel:
    """One probe kernel's wrapper: ``plain(*args)`` for CPU tensors,
    ``cuda(*args)`` (a kernel launch) for CUDA tensors, dispatched on the
    device of the second argument (the first data table)."""

    def __init__(self, name, line, source, plain, cuda):
        self.name = name
        self.replaces = f"benchmarks/probe_mosaic_gs.py:{line}"
        self.source = f"sslap_tpu_torch/ops/csrc/{source}"
        self.plain, self._cuda = plain, cuda
        self.launches = 0

    def __call__(self, *args, **kw):
        dev = args[1].device
        if dev.type == "cpu":
            return self.plain(*args, **kw)
        if dev.type != "cuda":
            raise RuntimeError(f"{self.name}: unsupported device {dev}")
        out = self._cuda(*args, **kw)
        self.launches += 1
        return out


# ---------------------------------------------------------------------------
# P1-P3: one 2-row copy into scratch at a runtime offset
# ---------------------------------------------------------------------------


def _copy_args(s, x, stride, scratch_rows):
    v = _ints(s)
    row, off = v[0], (v[1] * stride if stride else 0)
    _table(x, torch.int32, "copy source", aligned=x.is_cuda)
    _need(x.ndim == 2 and x.shape[1] == LINE and 0 <= row <= x.shape[0] - 2,
          f"copy: rows [{row}, {row + 2}) outside a {tuple(x.shape)} table")
    _need(0 <= off <= scratch_rows - 2,
          f"copy: scratch rows [{off}, {off + 2}) outside [0, "
          f"{scratch_rows})")
    return row, off


def _copy_probe(name, line, stride, scratch_rows):
    def plain(s, x):
        row, off = _copy_args(s, x, stride, scratch_rows)
        scratch = torch.zeros(scratch_rows, LINE, dtype=torch.int32,
                              device=x.device)
        scratch[off:off + 2] = x[row:row + 2]
        return scratch[off:off + 2].clone()

    def cuda(s, x):
        row, off = _copy_args(s, x, stride, scratch_rows)
        out = torch.empty(2, LINE, dtype=torch.int32, device=x.device)
        lib = _build.load()
        _build.check(lib.sslap_probe_copy(x.data_ptr(), row, off,
                                          scratch_rows, out.data_ptr(),
                                          _stream(x)), name)
        return out

    return ProbeKernel(name, line, "probe_copy.cu", plain, cuda)


dma_hbm_dynrows = _copy_probe("dma_hbm_dynrows", 38, 0, 8)
dma_vmem_dynoff2 = _copy_probe("dma_vmem_dynoff2", 65, 2, 8)
dma_vmem_dynoff8 = _copy_probe("dma_vmem_dynoff8", 94, 8, 16)


# ---------------------------------------------------------------------------
# P4-P5: read t[idx], write t[widx] = 7 * t[idx]
# ---------------------------------------------------------------------------


def _lane_args(s, vec):
    idx, widx = _ints(s)[:2]
    _table(vec, torch.int32, "lane table")
    _need(0 <= idx < vec.numel() and 0 <= widx < vec.numel(),
          f"lane: index outside a table of {vec.numel()}")
    return idx, widx


def _lane_probe(name, line):
    def plain(s, vec):
        idx, widx = _lane_args(s, vec)
        table = vec.clone()
        flat = table.view(-1)
        val = int(flat[idx])
        flat[widx] = _wrap32(7 * val)
        return table, _i32(val, device=vec.device)

    def cuda(s, vec):
        idx, widx = _lane_args(s, vec)
        table = vec.clone()
        out = torch.empty(1, dtype=torch.int32, device=vec.device)
        lib = _build.load()
        _build.check(lib.sslap_probe_lane(table.data_ptr(), idx, widx,
                                          out.data_ptr(), _stream(vec)), name)
        return table, out

    return ProbeKernel(name, line, "probe_lane.cu", plain, cuda)


lane_read_write = _lane_probe("lane_read_write", 122)
lane_read_write_2d = _lane_probe("lane_read_write_2d", 159)


# ---------------------------------------------------------------------------
# P6-P15: the queue-driven copy loops
# ---------------------------------------------------------------------------


def _queue_args(variant, s, hbm, q, vbm, pt, ot):
    """Validated (n, hbm, q copy, vbm, pt, ot): every row id a loop can
    reach (2 rid + 2 <= rows), every table index in range."""
    n = _ints(s)[0]
    _table(hbm, torch.int32, "hbm", aligned=hbm.is_cuda)
    _need(hbm.ndim == 2 and hbm.shape[1] == LINE and n >= 0,
          "queue probe: need [rows, 128] int32 rows and n >= 0")
    rows = hbm.shape[0]
    ids = torch.arange(n)[-1:]               # P6, P9: rows 2i, i < n
    if variant not in (6, 9):
        q = _table(q, torch.int32, "queue").clone()
        _need(q.numel() >= LINE and q.numel() >= n,
              f"queue probe: queue table of {q.numel()} < {max(n, LINE)}")
        ids = q.view(-1)[:n].cpu()
        if variant == 8:
            _need(q.numel() >= n + min(n, 4), "queue probe: no room to push")
            ids = torch.cat([ids, ids[:4] + 20])
    _need(bool(((ids >= 0) & (2 * ids + 2 <= rows)).all()),
          "queue probe: a row id outside the copy table")
    if variant == 10:
        _table(vbm, torch.float32, "vbm", aligned=vbm.is_cuda)
        _need(vbm.shape == hbm.shape, "qdma_dual: vbm shape != hbm shape")
    if variant in (11, 12):
        pt = _table(pt, torch.float32, "prices").clone()
        _need(not n or int(ids.max()) < pt.numel(),
              "qdma_alias: row id outside the price table")
    if variant == 11:
        ot = _table(ot, torch.int32, "owner").clone()
        _need(ot.numel() == pt.numel(), "qdma_alias3: owner size != prices")
    return n, hbm, q, vbm, pt, ot


def _queue_plain(variant, n, hbm, q, vbm, pt, ot):
    """The probe's loop, one iteration at a time (Python ints, wrapped to
    int32 where the kernel stores)."""
    qf = q.view(-1) if q is not None else None
    acc, i, tail = 0, 0, n
    while i < (tail if variant == 8 else n):
        rid = i if variant in (6, 9) else int(qf[i])
        rows = hbm[2 * rid:2 * rid + 2]
        if variant in (13, 15):          # the index comes from copied data
            qf[64 + int(rows[0, 0]) % 32] = _wrap32(acc + 7)
            acc += int(rows[1].sum())
        else:
            acc += int(rows[0].sum())
        if variant == 10:
            acc += int(vbm[2 * rid].sum().to(torch.int32))
        if variant in (11, 12):
            acc += int(pt.view(-1)[rid].to(torch.int32))
        if variant == 11:
            acc += int(ot.view(-1)[rid])
        if variant == 14:
            bits = (np.float32(1.5) * np.float32(i + 1)).view(np.int32)
            qf[100 + i % 8] = int(bits)
        if variant == 8 and i < 4:
            qf[tail] = rid + 20
            tail += 1
        i += 1
    return _i32(_wrap32(acc), device=hbm.device)


def _queue_outputs(variant, q, pt, ot, out):
    if variant in (6, 9):
        return (out,)
    if variant == 11:
        return q, pt, ot, out
    if variant == 12:
        return q, pt, out
    return q, out


def _queue_probe(name, line, order):
    """``order`` names the probe's inputs after ``s``, as its pallas_call
    takes them."""
    variant = _QUEUE_VARIANTS[name]

    def split(s, tables):
        kw = dict(zip(order, tables))
        return _queue_args(variant, s, kw["hbm"], kw.get("q"), kw.get("vbm"),
                           kw.get("pt"), kw.get("ot"))

    def plain(s, *tables):
        n, hbm, q, vbm, pt, ot = split(s, tables)
        out = _queue_plain(variant, n, hbm, q, vbm, pt, ot)
        return _queue_outputs(variant, q, pt, ot, out)

    def cuda(s, *tables):
        n, hbm, q, vbm, pt, ot = split(s, tables)
        out = torch.empty(1, dtype=torch.int32, device=hbm.device)
        ptr = (lambda t: 0 if t is None else t.data_ptr())  # noqa: E731
        lib = _build.load()
        _build.check(lib.sslap_probe_queue(
            variant, hbm.data_ptr(), ptr(vbm), ptr(q), ptr(pt), ptr(ot), n,
            out.data_ptr(), _stream(hbm)), name)
        return _queue_outputs(variant, q, pt, ot, out)

    return ProbeKernel(name, line, "probe_queue.cu", plain, cuda)


while_double_buffer = _queue_probe("while_double_buffer", 194, ("hbm",))
while_qtable_dma = _queue_probe("while_qtable_dma", 305, ("hbm", "q"))
while_qtable_dma_store = _queue_probe("while_qtable_dma_store", 359,
                                      ("hbm", "q"))
sem_2d_dynamic = _queue_probe("sem_2d_dynamic", 426, ("hbm",))
qdma_dual = _queue_probe("qdma_dual", 470, ("hbm", "vbm", "q"))
qdma_alias3 = _queue_probe("qdma_alias3", 529, ("hbm", "q", "pt", "ot"))
qdma_alias2 = _queue_probe("qdma_alias2", 592, ("hbm", "q", "pt"))
qdma_store_datadep = _queue_probe("qdma_store_datadep", 649, ("hbm", "q"))
qdma_store_bitcast = _queue_probe("qdma_store_bitcast", 713, ("hbm", "q"))
qdma_store_via_dma = _queue_probe("qdma_store_via_dma", 770, ("hbm", "q"))


# ---------------------------------------------------------------------------
# P16-P17: K3 rebuilt in stages
# ---------------------------------------------------------------------------


def _window(K: int) -> int:
    """Entries per bulk copy of a row: 16-byte aligned, covering the row's
    K entries at any offset."""
    return (K + 3 + 3) // 4 * 4


def _ladder_args(counts, clines, vlines, q, p, o, K, stage):
    """Validated (qcount, max_bids, cap): the ring fits its table, every
    queued row and owner is a row whose window lies inside the padded row
    data, every column a price-table index."""
    qcount, max_bids, cap = _ints(counts)[:3]
    _need(stage in (1, 2, 3), f"ladder: stage must be 1-3, got {stage}")
    _table(clines, torch.int32, "clines", aligned=clines.is_cuda)
    _table(vlines, torch.float32, "vlines", aligned=vlines.is_cuda)
    _need(clines.shape == vlines.shape and K >= 1,
          "ladder: clines/vlines shapes differ")
    rows_ok = (clines.numel() - _window(K)) // K + 1
    m = p.numel()
    _need(o.numel() == m, "ladder: owner size != prices size")
    _need(0 <= qcount < cap <= q.numel(),
          f"ladder: need 0 <= qcount < cap <= {q.numel()}, got qcount="
          f"{qcount}, cap={cap}")
    ids = q.reshape(-1)[:qcount]
    _need(not qcount or bool(((ids >= 0) & (ids < rows_ok)).all()),
          "ladder: a queued row outside the padded row data")
    _need(not m or int(o.max()) < rows_ok, "ladder: owner names a bad row")
    _need(bool(((clines >= 0) & (clines < m)).all()),
          "ladder: a column outside the price table")
    return qcount, max_bids, cap


def _ladder_plain(stage, counts, clines, vlines, q, p, o, K):
    """The stage's loop, one bid at a time, in numpy float32 scalars on
    host copies (q, p, o are modified in place)."""
    qcount, max_bids, cap = counts
    c = clines.cpu().numpy().reshape(-1)
    v = vlines.cpu().numpy().reshape(-1)
    zero, half = np.float32(0), np.float32(0.5)
    acc = zero
    head, tail, bids = 0, qcount, 0
    while head != tail and bids < max_bids:
        u = int(q[head])
        head = 0 if head + 1 == cap else head + 1
        j = c[u * K]
        pk = p[j] + zero
        acc = (acc + pk) + (v[u * K] + zero)
        if stage >= 3:
            prev = o[j]
            if prev >= 0:
                q[tail] = prev
                tail = 0 if tail + 1 == cap else tail + 1
        if stage >= 2:
            p[j] = pk + half
            o[j] = u
        bids += 1
    left = tail - head if tail >= head else tail - head + cap
    return np.array([bids, left], np.int32), np.array([acc], np.float32)


def _ladder_cuda(stage, unified, counts, clines, vlines, q, p, o, K):
    qcount, max_bids, cap = counts
    dev = clines.device
    _build.check_smem(8 * _window(K), dev, f"gs_ladder at K = {K}")
    stats = torch.empty(2, dtype=torch.int32, device=dev)
    acc = torch.empty(1, dtype=torch.float32, device=dev)
    lib = _build.load()
    _build.check(lib.sslap_probe_ladder(
        stage, int(unified), clines.data_ptr(), vlines.data_ptr(), K,
        q.data_ptr(), p.data_ptr(), o.data_ptr(), qcount, max_bids, cap,
        stats.data_ptr(), acc.data_ptr(), _stream(clines)),
        "gs_ladder_uni" if unified else "gs_ladder")
    return stats, acc


def _copies(unified, tables):
    """New state tables (the wrapper's outputs): one int32 [3, W] table
    (queue | price bits | owner), or queue, prices, owner."""
    if unified:
        return [_table(tables[0], torch.int32, "state").clone()]
    return [_table(t, dt, nm).clone() for t, dt, nm in zip(
        tables, (torch.int32, torch.float32, torch.int32),
        ("queue", "prices", "owner"))]


def _views(unified, tables):
    """(queue, prices, owner) of the state tables, flat."""
    if unified:
        st = tables[0]
        return st[0], st[1].view(torch.float32), st[2]
    return tuple(t.view(-1) for t in tables)


def _ladder_probe(name, line, unified):
    """P16 (unified state table) or P17 (three tables): the wrapper takes
    (counts, clines, vlines, *tables, K=, stage=) and returns (*tables,
    stats, acc)."""
    def plain(counts, clines, vlines, *tables, K, stage):
        tables = _copies(unified, tables)
        counts = _ladder_args(counts, clines, vlines,
                              *_views(unified, tables), K, stage)
        host = [t.cpu() for t in tables]
        stats, acc = _ladder_plain(
            stage, counts, clines, vlines,
            *(v.numpy() for v in _views(unified, host)), K)
        dev = clines.device
        return (*(t.to(dev) for t in host), torch.from_numpy(stats).to(dev),
                torch.from_numpy(acc).to(dev))

    def cuda(counts, clines, vlines, *tables, K, stage):
        tables = _copies(unified, tables)
        q, p, o = _views(unified, tables)
        counts = _ladder_args(counts, clines, vlines, q, p, o, K, stage)
        return (*tables, *_ladder_cuda(stage, unified, counts, clines,
                                       vlines, q, p, o, K))

    return ProbeKernel(name, line, "probe_ladder.cu", plain, cuda)


gs_ladder_uni = _ladder_probe("gs_ladder_uni", 838, unified=True)
gs_ladder = _ladder_probe("gs_ladder", 997, unified=False)


# ---------------------------------------------------------------------------
# The probes' inputs, registry and asserts
# ---------------------------------------------------------------------------


def _rows_of_ones():
    return np.ones((64, LINE), np.int32)


def _queue_table(N):
    return np.concatenate([np.arange(N, dtype=np.int32)[::-1],
                           np.zeros(LINE - N, np.int32)]).reshape(1, LINE)


def _row_index_table():
    return np.broadcast_to(np.arange(64, dtype=np.int32)[:, None],
                           (64, LINE)).copy()


def ladder_inputs(n, m, K, cap, *, unified, stage, max_bids=10 ** 5,
                  prices=None):
    """The ladder probes' construction (probe_mosaic_gs.py:945-958,
    1097-1108) at any size: rng 3; cols sorted, then ``cols[:, 0] =
    arange(n)`` (needs m >= n); vals in [0, 10); line-packed with NL =
    (K + 254) // 128 spare lines; rows 0..n-1 queued; prices 0 (or
    ``prices``), owner -1; tables 128-wide rows."""
    rng = np.random.default_rng(3)
    cols = np.sort(rng.integers(0, m, (n, K)), axis=1).astype(np.int32)
    cols[:, 0] = np.arange(n)
    vals = (rng.random((n, K)) * 10).astype(np.float32)
    NL = (K + 2 * (LINE - 1)) // LINE
    flatc = np.zeros(((n * K) // LINE + NL) * LINE, np.int32)
    flatv = np.zeros_like(flatc, dtype=np.float32)
    flatc[:n * K] = cols.reshape(-1)
    flatv[:n * K] = vals.reshape(-1)
    up = lambda k: -(-k // LINE) * LINE  # noqa: E731
    counts = (n, max_bids, cap)
    p0 = np.zeros(m, np.float32) if prices is None else prices
    lines = (flatc.reshape(-1, LINE), flatv.reshape(-1, LINE))
    if unified:
        W = up(max(cap, m))
        state = np.zeros((3, W), np.int32)
        state[0, :n] = np.arange(n)
        state[1, :m] = p0.view(np.int32)
        state[2] = -1
        return (counts, *lines, state), dict(K=K, stage=stage)
    q = np.zeros(up(cap), np.int32)
    q[:n] = np.arange(n)
    p = np.zeros(up(m), np.float32)
    p[:m] = p0
    o = np.full(up(m), -1, np.int32)
    return ((counts, *lines, q.reshape(-1, LINE), p.reshape(-1, LINE),
             o.reshape(-1, LINE)), dict(K=K, stage=stage))


def _gs_inputs(prefetch=True, scan="full"):
    """probe_mosaic_gs.py:_gs_run's instance (:272-291)."""
    rng = np.random.default_rng(3)
    n = m = 32
    K = 4
    cols = np.sort(rng.integers(0, m, (n, K)), axis=1).astype(np.int32)
    cols[:, 0] = np.arange(n)
    cols = np.sort(cols, axis=1)
    vals = (rng.random((n, K)) * 10).astype(np.float32)
    queue = np.full(n + 1, -1, np.int32)
    queue[:n] = np.arange(n)
    return ((cols, vals, queue, n, np.zeros(m, np.float32),
             np.full(m, -1, np.int32), 0.5, 12.0, 10 ** 6),
            dict(prefetch=prefetch, _scan=scan))


_INPUTS = {
    "dma_hbm_dynrows": lambda: (((5,), np.arange(64 * LINE, dtype=np.int32)
                                 .reshape(64, LINE)), {}),
    "dma_vmem_dynoff2": lambda: (((5, 1), np.arange(64 * LINE, dtype=np
                                  .int32).reshape(64, LINE)), {}),
    "dma_vmem_dynoff8": lambda: (((5, 1), np.arange(64 * LINE, dtype=np
                                  .int32).reshape(64, LINE)), {}),
    "lane_read_write": lambda: (((300, 37), np.arange(512, dtype=np.int32)),
                                {}),
    "lane_read_write_2d": lambda: (((300, 37), np.arange(512, dtype=np.int32)
                                    .reshape(4, LINE)), {}),
    "while_double_buffer": lambda: (((16,), np.ones((32, LINE), np.int32)),
                                    {}),
    "gs_small_noprefetch": lambda: _gs_inputs(prefetch=False),
    "gs_small_constscan": lambda: _gs_inputs(scan="const"),
    "gs_small_noprices": lambda: _gs_inputs(scan="noprices"),
    "gs_small": lambda: _gs_inputs(),
    "while_qtable_dma": lambda: (((12,), _rows_of_ones(), _queue_table(12)),
                                 {}),
    "while_qtable_dma_store": lambda: (((12,), _rows_of_ones(),
                                        _queue_table(12)), {}),
    "sem_2d_dynamic": lambda: (((8,), np.ones((32, LINE), np.int32)), {}),
    "qdma_dual": lambda: (((12,), _rows_of_ones(),
                           np.ones((64, LINE), np.float32), _queue_table(12)),
                          {}),
    "qdma_alias3": lambda: (((12,), _rows_of_ones(), _queue_table(12),
                             np.ones((1, LINE), np.float32),
                             np.full((1, LINE), 2, np.int32)), {}),
    "qdma_alias2": lambda: (((12,), _rows_of_ones(), _queue_table(12),
                             np.ones((1, LINE), np.float32)), {}),
    "qdma_store_datadep": lambda: (((12,), _row_index_table(),
                                    _queue_table(12)), {}),
    "qdma_store_bitcast": lambda: (((12,), _rows_of_ones(),
                                    _queue_table(12)), {}),
    "qdma_store_via_dma": lambda: (((12,), _row_index_table(),
                                    _queue_table(12)), {}),
}
for _s in (1, 2, 3):
    _INPUTS[f"gs_uni{_s}"] = (lambda s=_s: ladder_inputs(
        32, 32, 4, 33, unified=True, stage=s))
    _INPUTS[f"gs_ladder{_s}"] = (lambda s=_s: ladder_inputs(
        32, 32, 4, 33, unified=False, stage=s))

# probe name -> its wrapper, in benchmarks/probe_mosaic_gs.py's order
PROBES = {name: kernel for name, kernel in (
    ("dma_hbm_dynrows", dma_hbm_dynrows),
    ("dma_vmem_dynoff2", dma_vmem_dynoff2),
    ("dma_vmem_dynoff8", dma_vmem_dynoff8),
    ("lane_read_write", lane_read_write),
    ("lane_read_write_2d", lane_read_write_2d),
    ("while_double_buffer", while_double_buffer),
    ("gs_small_noprefetch", gs_auction_device),
    ("gs_small_constscan", gs_auction_device),
    ("gs_small_noprices", gs_auction_device),
    ("gs_small", gs_auction_device),
    ("while_qtable_dma", while_qtable_dma),
    ("while_qtable_dma_store", while_qtable_dma_store),
    ("sem_2d_dynamic", sem_2d_dynamic),
    ("qdma_dual", qdma_dual),
    ("qdma_alias3", qdma_alias3),
    ("qdma_alias2", qdma_alias2),
    ("qdma_store_datadep", qdma_store_datadep),
    ("qdma_store_bitcast", qdma_store_bitcast),
    ("qdma_store_via_dma", qdma_store_via_dma),
    ("gs_uni1", gs_ladder_uni), ("gs_uni2", gs_ladder_uni),
    ("gs_uni3", gs_ladder_uni),
    ("gs_ladder1", gs_ladder), ("gs_ladder2", gs_ladder),
    ("gs_ladder3", gs_ladder))}

# The hand kernels behind the probes, P1-P17 (gs_small* run K3).
KERNELS = {f"P{i + 1}": k for i, k in enumerate(
    [dma_hbm_dynrows, dma_vmem_dynoff2, dma_vmem_dynoff8, lane_read_write,
     lane_read_write_2d, while_double_buffer, while_qtable_dma,
     while_qtable_dma_store, sem_2d_dynamic, qdma_dual, qdma_alias3,
     qdma_alias2, qdma_store_datadep, qdma_store_bitcast, qdma_store_via_dma,
     gs_ladder_uni, gs_ladder])}

# The reference's order (probe_mosaic_gs.py:1164-1175: its list, then the
# probes it leaves out, in registry order).
ORDER = ("qdma_store_via_dma", "qdma_store_bitcast", "qdma_dual",
         "qdma_alias2", "qdma_alias3", "gs_ladder1", "gs_ladder2",
         "gs_ladder3", "while_qtable_dma", "while_qtable_dma_store",
         "sem_2d_dynamic", "while_double_buffer", "gs_small_noprefetch",
         "gs_small_constscan", "gs_small_noprices", "gs_small",
         "dma_hbm_dynrows", "dma_vmem_dynoff2", "dma_vmem_dynoff8",
         "lane_read_write", "lane_read_write_2d", "qdma_store_datadep",
         "gs_uni1", "gs_uni2", "gs_uni3")


def make_inputs(name):
    """(args, kwargs) of probe ``name``, as its reference builds them:
    numpy arrays for tables, Python ints (tuples) for scalars."""
    return _INPUTS[name]()


def to_device(args, device):
    """numpy tables -> tensors on ``device``; scalars stay on the host."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 if isinstance(a, np.ndarray) else a for a in args)


def run(name, device="cuda", *, plain=False):
    """Probe ``name`` on ``device``: its wrapper (or its plain version)
    on the probe's own inputs; returns the outputs as a tuple."""
    args, kw = make_inputs(name)
    fn = plain_of(PROBES[name]) if plain else PROBES[name]
    out = fn(*to_device(args, device), **kw)
    return out if isinstance(out, tuple) else (out,)


def plain_of(kernel):
    """The plain version of a probe's wrapper."""
    return gs_auction_plain if kernel is gs_auction_device else kernel.plain


def _expect(cond, what):
    if not cond:
        raise AssertionError(what)


_ACC = {"while_double_buffer": 16 * 128, "while_qtable_dma": 12 * 128,
        "while_qtable_dma_store": (12 + 4) * 128, "sem_2d_dynamic": 8 * 128,
        "qdma_dual": 12 * 256, "qdma_alias3": 12 * (128 + 2 + 1),
        "qdma_alias2": 12 * (128 + 1),
        "qdma_store_datadep": sum((2 * r + 1) * 128 for r in range(12)),
        "qdma_store_bitcast": 12 * 128,
        "qdma_store_via_dma": sum((2 * r + 1) * 128 for r in range(12))}


def check(name, outputs):
    """The reference probe's own asserts on the port's outputs."""
    out = [o.cpu() for o in outputs]
    if name.startswith("dma_"):
        x = make_inputs(name)[0][1]
        _expect((out[0].numpy() == x[5:7]).all(), "wrong rows")
    elif name.startswith("lane_read_write"):
        _expect(int(out[1][0]) == 300, f"read {int(out[1][0])}")
        _expect(int(out[0].reshape(-1)[37]) == 2100,
                f"write {int(out[0].reshape(-1)[37])}")
    elif name in _ACC:
        _expect(int(out[-1][0]) == _ACC[name],
                f"acc {int(out[-1][0])} != {_ACC[name]}")
    elif name.startswith(("gs_uni", "gs_ladder")):
        _expect(int(out[-2][0]) == 32, f"bids={int(out[-2][0])}")
    elif name in ("gs_small", "gs_small_noprefetch"):
        owner, bids, left = out[1], int(out[3]), int(out[4])
        _expect(left == 0, f"left={left}")
        _expect(bids >= 32, f"bids={bids}")
        _expect((np.sort(owner.numpy()) == np.arange(32)).all(),
                "owner is not a permutation")
    else:                     # the stubbed scans need only run
        _expect(int(out[3]) >= 1, f"bids={int(out[3])}")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    for name in (argv or ORDER):
        outputs = run(name, "cuda")
        torch.cuda.synchronize()
        check(name, outputs)
        print(f"{name}: PASS", flush=True)


if __name__ == "__main__":
    main()
