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
            -> csrc/probe_queue.cu  (P6 and P9 a TMA ring spread over
               the grid; P7, P8, P10-P12 and P14 passes of 32 positions
               a warp over segments, a variant each; P13 and P15 passes
               of 32 positions a warp, cut at a written slot, one bulk
               write back)
    P16     gs_ladder_uni (probes gs_uni1-3)
    P17     gs_ladder (probes gs_ladder1-3)
            -> csrc/probe_ladder.cu (both: look-ahead gather warps and an
               in-order commit warp; stages 1-3)

and the probes ``gs_small``, ``gs_small_noprefetch``,
``gs_small_constscan`` and ``gs_small_noprices`` drive K3 itself
(``gs_auction_device(..., prefetch=, _scan=)``).  A wrapper takes the
probe's inputs (its scalar array first, as a sequence of ints or an int
tensor, then the tables as tensors) and returns what the Pallas call
returns, in its shapes and dtypes, aliased tables as new tensors; the
ladder kernels also return ``acc`` (f32 [1]).  CPU tensors run the plain
version, CUDA tensors launch the kernel or raise; ``.launches`` counts
launches.  The ladder kernels also take any n, m, K and cap
(``ladder_inputs``, whose ``first=`` also makes instances whose first
columns repeat), so they run at the headline's scale.  A P7-P15 loop
raises ValueError at the first row id it reads outside the tables, on
either device (the kernels report it in an error word).  ``pump_mirror``,
``queue_pass_mirror``, ``store_pass_mirror`` and
``ladder_lookahead_mirror`` replay the kernels' protocols on the CPU (P6
and P9's split over blocks; P7-P14's segments, passes and forwarded row
ids; P13 and P15's passes cut at a written slot; P16-P17's stale
look-ahead snapshots, stamp validation and passes), for the tests to hold
against the plain versions; ``ladder_counters()`` reads the last ladder
launch's counters.

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
# P6 (csrc/probe_queue.cu): iterations a block takes at least, and the
# kernel's summing warps (kPumpConsumers)
PUMP_CHUNK = 64
PUMP_CONSUMERS = 4
# P7, P8, P10-P12, P14 (csrc/probe_queue.cu, queue_pass_kernel): positions
# a one-warp block takes (a multiple of 32), and the kernel's error word
# when no row id was out of range (kNoBad)
QUEUE_SEGMENT = 512
NO_BAD = 2 ** 63 - 1
# P13, P15 (csrc/probe_queue.cu, store_pass_kernel): positions a one-warp
# block takes (a multiple of 32, >= 128), and the int32 a block's record
# holds (kRec)
STORE_SEGMENT = 512
STORE_RECORD = 68
# P16-P17 (csrc/probe_ladder.cu): gather warps beside the commit warp (1-8),
# the kernel's stamp table (kStampBits) and its ring of recent pushes
# (kRecent)
GATHER_WARPS = 4
STAMP_BITS = 12
RECENT = 64
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
    """Validated (n, hbm, q copy, vbm, pt, ot, limit): every table index in
    range, and P6 and P9's rows 2i, i < n, inside the copy table.  A loop
    that reads its row ids from the queue (P7-P15) checks each id it reads
    against ``limit`` (rows // 2, and the price table's size for P11-P12):
    P8, P13 and P14 store into the queue, so a later iteration can read a
    slot the loop wrote."""
    n = _ints(s)[0]
    _table(hbm, torch.int32, "hbm", aligned=hbm.is_cuda)
    _need(hbm.ndim == 2 and hbm.shape[1] == LINE and n >= 0,
          "queue probe: need [rows, 128] int32 rows and n >= 0")
    limit = hbm.shape[0] // 2
    if variant in (6, 9):                  # rows 2i, i < n
        _need(n <= limit, f"queue probe: a row id outside the copy table "
              f"(rows 2i, i < {n}, of {hbm.shape[0]})")
    else:
        q = _table(q, torch.int32, "queue").clone()
        _need(q.numel() >= LINE and q.numel() >= n,
              f"queue probe: queue table of {q.numel()} < {max(n, LINE)}")
        if variant == 8:
            _need(q.numel() >= n + min(n, 4), "queue probe: no room to push")
    if variant == 10:
        _table(vbm, torch.float32, "vbm", aligned=vbm.is_cuda)
        _need(vbm.shape == hbm.shape, "qdma_dual: vbm shape != hbm shape")
    if variant in (11, 12):
        pt = _table(pt, torch.float32, "prices").clone()
        limit = min(limit, pt.numel())
    if variant == 11:
        ot = _table(ot, torch.int32, "owner").clone()
        _need(ot.numel() == pt.numel(), "qdma_alias3: owner size != prices")
    return n, hbm, q, vbm, pt, ot, limit


def _bad_row(i, rid, limit):
    """The error of a loop that reads row id ``rid`` at position ``i``."""
    return ValueError(f"queue probe: row id {rid} read at position {i} is "
                      f"outside the tables (ids in [0, {limit}))")


def _queue_plain(variant, n, hbm, q, vbm, pt, ot, limit):
    """The probe's loop, one iteration at a time (Python ints, wrapped to
    int32 where the kernel stores); raises ``_bad_row`` at the first row id
    outside [0, limit)."""
    qf = q.view(-1) if q is not None else None
    acc, i, tail = 0, 0, n
    while i < (tail if variant == 8 else n):
        rid = i if variant in (6, 9) else int(qf[i])
        if not 0 <= rid < limit:
            raise _bad_row(i, rid, limit)
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


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def pump_blocks(n: int, sms: int) -> int:
    """P6's grid: a block per PUMP_CHUNK iterations, at most one per SM,
    at least one."""
    return max(1, min(sms, -(-n // PUMP_CHUNK)))


def pump_mirror(hbm, n: int, blocks: int):
    """P6's kernel (csrc/probe_queue.cu, pump_kernel) on the CPU: block b
    takes iterations [n b / B, n (b + 1) / B), its consumer warp w the k-th
    of them for k = w mod PUMP_CONSUMERS; each sums its rows 2i into a
    uint32 partial, the block adds its warps' partials, and out adds the
    blocks' (all wrapping).  Returns int32 [1], as the probe."""
    rows = np.asarray(hbm).reshape(-1, LINE)[0:2 * n:2].view(np.uint32)
    total = np.uint32(0)
    with np.errstate(over="ignore"):
        for b in range(blocks):
            lo, hi = n * b // blocks, n * (b + 1) // blocks
            for w in range(PUMP_CONSUMERS):
                total += rows[lo + w:hi:PUMP_CONSUMERS].sum(dtype=np.uint32)
    return torch.tensor([total.view(np.int32)], dtype=torch.int32)


def queue_total(variant: int, n: int) -> int:
    """The positions P7-P14's loop runs: n, and P8 pushes four more when
    n > 0."""
    return n + 4 if variant == 8 and n > 0 else n


def queue_blocks(total: int, segment: int = None) -> int:
    """P7, P8, P10-P12 and P14's grid: one one-warp block per ``segment``
    positions (default QUEUE_SEGMENT), at least one."""
    return max(1, -(-total // (segment or QUEUE_SEGMENT)))


def _f32_row_sums(rows):
    """The f32 sum of each [128] row in queue_pass_kernel's order: lane l's
    entries 4l..4l+3 left to right, then a butterfly over the 32 lanes
    (xor 16, 8, 4, 2, 1); lane 0's value."""
    f = rows.reshape(-1, 32, 4)
    f = ((f[..., 0] + f[..., 1]) + f[..., 2]) + f[..., 3]
    lanes = np.arange(32)
    for d in (16, 8, 4, 2, 1):
        f = f + f[:, lanes ^ d]
    return f[:, 0]


def _bits_of(i):
    """The int32 bits of 1.5 * (i + 1) in float32 (P14's stored value)."""
    return (np.float32(1.5) * np.asarray(i + 1).astype(np.float32)).view(
        np.int32)


@np.errstate(over="ignore")
def queue_pass_mirror(variant, n, hbm, q, limit, vbm=None, pt=None, ot=None,
                      segment=None):
    """P7, P8, P10-P12 and P14's kernel (csrc/probe_queue.cu,
    queue_pass_kernel) on the CPU: the variant's positions (queue_total)
    cut into segments of ``segment`` (default QUEUE_SEGMENT), each taken in
    passes of up to 32.  A pass reads its row ids as the call found the
    queue, but forwards the slots the loop writes (P8's position p >= n
    reads q[p mod n] + 20 (p // n); P14's position p in [100, 108) the
    bits of 1.5 (p - 3)), keeps the positions before its first id out of
    range and adds their rows (P10: and the f32 sums of their vbm rows in
    the kernel's order; P11-P12: their prices and owners) into a wrapping
    partial; a segment stops at its first bad id.  The partials add up; the
    lowest bad position raises ``_bad_row``; block 0 then applies the
    loop's stores (P8's pushes, P14's eight slots).  ``q`` (numpy, flat) is
    modified in place; returns out (int32 [1]) and the counts (segments,
    passes, forwarded: positions whose id was forwarded)."""
    segment = segment or QUEUE_SEGMENT
    h = np.asarray(hbm).reshape(-1, LINE)
    q0 = q.copy()                        # no position reads a written slot
    total = queue_total(variant, n)
    count = dict(segments=0, passes=0, forwarded=0)

    def ids(pos):                        # (row ids, forwarded?)
        rid = q0[pos].astype(np.int64)
        fwd = np.zeros(pos.size, bool)
        if variant == 8:
            fwd = pos >= n
            base = q0[np.where(fwd, pos % max(n, 1), 0)].astype(np.int64)
            rid = np.where(fwd, base + 20 * (pos // max(n, 1)), rid)
        if variant == 14:
            fwd = (pos >= 100) & (pos < 108)
            rid = np.where(fwd, _bits_of(pos - 4), rid)
        return (rid + 2 ** 31) % 2 ** 32 - 2 ** 31, fwd

    acc, bad = np.uint32(0), None
    for lo in range(0, queue_blocks(total, segment) * segment, segment):
        for t in range(lo, min(total, lo + segment), 32):
            pos = np.arange(t, min(t + 32, lo + segment, total))
            rid, fwd = ids(pos)
            valid = (rid >= 0) & (rid < limit)
            k = pos.size if valid.all() else int(np.argmin(valid))
            r = rid[:k]
            acc += h[2 * r].view(np.uint32).sum(dtype=np.uint32)
            if variant == 10:
                v = np.asarray(vbm, np.float32).reshape(-1, LINE)[2 * r]
                acc += _f32_row_sums(v).astype(np.int32).view(
                    np.uint32).sum(dtype=np.uint32)
            if variant in (11, 12):
                acc += np.asarray(pt).reshape(-1)[r].astype(np.int32).view(
                    np.uint32).sum(dtype=np.uint32)
            if variant == 11:
                acc += np.asarray(ot).reshape(-1)[r].view(np.uint32).sum(
                    dtype=np.uint32)
            count["passes"] += 1
            count["forwarded"] += int(fwd[:k].sum())
            if k < pos.size:             # segments run in position order
                bad = bad or (t + k, int(rid[k]))
                break
        count["segments"] += 1
    if bad is not None:
        raise _bad_row(*bad, limit)
    if variant == 8 and n > 0:
        q[n:n + 4] = ids(np.arange(4))[0] + 20
    if variant == 14:
        for r in range(min(8, total)):
            q[100 + r] = _bits_of(r + 8 * ((total - 1 - r) // 8))
    return torch.tensor([acc.view(np.int32)]), count


def store_blocks(n: int, segment: int = None) -> int:
    """P15's grid: one one-warp block per ``segment`` positions (default
    STORE_SEGMENT), at least one."""
    return max(1, -(-n // (segment or STORE_SEGMENT)))


@np.errstate(over="ignore")
def store_pass_mirror(n, hbm, q, limit, segment=None):
    """P15's kernel (csrc/probe_queue.cu, store_pass_kernel) on the CPU:
    segments of ``segment`` positions (default STORE_SEGMENT), each taken in
    passes of up to 32 that end before the first position whose queue slot
    an earlier position of the pass writes; per pass an exclusive scan with
    the carried acc and, per slot, the highest position writing it; segment
    0 reads the queue's first row with its stores applied.  One segment
    writes that row back; with more, the merge takes the segment sums'
    prefix and per slot the last segment that wrote it.  ``q`` (numpy,
    flat) is modified in place; returns out (int32 [1]) and the counts
    (passes, cut: passes cut at a written slot), or raises ``_bad_row``."""
    segment = segment or STORE_SEGMENT
    h = np.asarray(hbm).reshape(-1, LINE)
    row = q[:LINE].copy()                # segment 0's row in shared memory
    count = dict(passes=0, cut=0)
    records = []
    for lo in range(0, store_blocks(n, segment) * segment, segment):
        hi = min(n, lo + segment)
        acc, bad = np.uint32(0), None
        last = {}                        # slot -> (position, acc there)
        t = lo
        while t < hi:
            act = min(32, hi - t)
            pos = np.arange(t, t + act)
            rid = np.where(pos < LINE, row[np.minimum(pos, LINE - 1)],
                           q[pos]) if lo == 0 else q[pos]
            valid = (rid >= 0) & (rid < limit)
            safe = np.where(valid, rid, 0)
            tgt = 64 + (h[2 * safe, 0] & 31)
            d = tgt - t
            lanes = np.arange(act)
            marks = d[valid & (d > lanes) & (d < 32)]
            k = int(marks.min()) if marks.size else 32
            if not valid.all() and int(np.argmin(valid)) < k:
                b = int(np.argmin(valid))
                bad = (t + b, int(rid[b]))
                break
            k = min(k, act)
            s = h[2 * safe[:k] + 1].view(np.uint32).sum(axis=1,
                                                        dtype=np.uint32)
            mine = acc + np.concatenate(
                [[np.uint32(0)], np.cumsum(s, dtype=np.uint32)[:-1]])
            acc = acc + s.sum(dtype=np.uint32)
            for lane in range(k):        # the highest lane on a slot wins
                if not (tgt[lane + 1:k] == tgt[lane]).any():
                    if lo == 0:
                        row[tgt[lane]] = (mine[lane] + np.uint32(7)).view(
                            np.int32)
                    last[int(tgt[lane])] = (t + lane, mine[lane])
            count["passes"] += 1
            count["cut"] += int(k < act)
            t += k
        records.append((acc, bad, last))
    if len(records) == 1:
        acc, bad, _ = records[0]
    else:
        bad = next((r[1] for r in records if r[1] is not None), None)
        prefix = np.concatenate([[np.uint32(0)], np.cumsum(
            [r[0] for r in records], dtype=np.uint32)])
        acc = prefix[-1]
        row = q[:LINE].copy()
        for slot in range(64, 96):
            g = max((g for g, r in enumerate(records) if slot in r[2]),
                    default=None)
            if g is not None:
                row[slot] = (prefix[g] + records[g][2][slot][1]
                             + np.uint32(7)).view(np.int32)
    if bad is not None:
        raise _bad_row(*bad, limit)
    q[:LINE] = row
    return torch.tensor([np.uint32(acc).view(np.int32)]), count


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
        n, hbm, q, vbm, pt, ot, limit = split(s, tables)
        out = _queue_plain(variant, n, hbm, q, vbm, pt, ot, limit)
        return _queue_outputs(variant, q, pt, ot, out)

    def cuda(s, *tables):
        n, hbm, q, vbm, pt, ot, limit = split(s, tables)
        lib = _build.load()
        dev = hbm.device
        if variant in (6, 9):            # one function: P6's pump kernel
            blocks = pump_blocks(n, _sms(dev))
            out = (torch.zeros if blocks > 1 else torch.empty)(
                1, dtype=torch.int32, device=dev)
            _build.check(lib.sslap_probe_pump(
                hbm.data_ptr(), n, blocks, out.data_ptr(), _stream(hbm)),
                name)
            return (out,)
        if variant in (13, 15):          # one function: P15's store passes
            # out[0] the probe's out, out[1:3] the first bad row id's
            # position and id
            out = torch.empty(3, dtype=torch.int32, device=dev)
            blocks = store_blocks(n)
            more = blocks > 1
            scratch = torch.empty(STORE_RECORD * blocks if more else 0,
                                  dtype=torch.int32, device=dev)
            arrived = (torch.zeros(1, dtype=torch.int32, device=dev)
                       if more else scratch)
            _build.check(lib.sslap_probe_store(
                hbm.data_ptr(), q.data_ptr(), n, limit, STORE_SEGMENT,
                blocks, scratch.data_ptr(), arrived.data_ptr(),
                out.data_ptr(), _stream(hbm)), name)
            pos, rid = out[1:3].tolist()          # synchronises
            if pos >= 0:
                raise _bad_row(pos, rid, limit)
            return q, out[:1]
        # out[0]: the sum in its low 32 bits; out[1]: the first bad row id
        # as (position << 32 | id), or NO_BAD
        blocks = queue_blocks(queue_total(variant, n))
        out = (torch.tensor([0, NO_BAD], dtype=torch.int64, device=dev)
               if blocks > 1 else torch.empty(2, dtype=torch.int64,
                                              device=dev))
        ptr = (lambda t: 0 if t is None else t.data_ptr())  # noqa: E731
        _build.check(lib.sslap_probe_queue(
            variant, hbm.data_ptr(), ptr(vbm), q.data_ptr(), ptr(pt),
            ptr(ot), n, limit, QUEUE_SEGMENT, blocks, out.data_ptr(),
            _stream(hbm)), name)
        key = int(out[1])                         # synchronises
        if key != NO_BAD:
            raise _bad_row(key >> 32, _wrap32(key & 0xFFFFFFFF), limit)
        return _queue_outputs(variant, q, pt, ot, out.view(torch.int32)[:1])

    kernel = ProbeKernel(name, line, "probe_queue.cu", plain, cuda)
    kernel.order = order          # the tables after s, as the probe takes them
    return kernel


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


def ladder_lookahead_mirror(stage, counts, clines, vlines, q, p, o, K, *,
                            gather_warps=GATHER_WARPS, stamp_bits=STAMP_BITS,
                            snapshot="stalest", seed=0):
    """P16-P17's look-ahead protocol (csrc/probe_ladder.cu, lookahead_kernel)
    on the CPU: ``_ladder_plain``'s arguments (q, p, o numpy arrays,
    modified in place) and results, plus the kernel's counters.

    Positions t are committed in ring order, in passes of up to 32.  The
    gather lane of t read queue[t], the row's first entry and the column's
    price and owner as they stood after c0 commits, c0 in [max(0, t - S +
    1), t0] with S = 64 G (its slot is free only then) and t0 the pass's
    first position (the lane published before the pass): the stalest allowed
    (``snapshot="stalest"``, passes of 32), or drawn from ``seed``
    (``"random"``, with passes of random length, and a quarter of the
    positions read by the commit warp itself, a pass of one, as when no
    lane has claimed one).  A pass ends before a position whose column an
    earlier position of the pass takes.  A lane's values are re-read when a
    commit before the pass, in [c0, t), stamped its column's hash
    (``stamp_bits`` bits; a small table forces collisions); the pass's own
    stamps land at its end.  A self-read row of a recent push comes from
    the ring of RECENT pushes, as in the kernel."""
    if snapshot not in ("stalest", "random"):
        raise ValueError(f"snapshot must be 'stalest' or 'random', got "
                         f"{snapshot!r}")
    qcount, max_bids, cap = counts
    c = clines.cpu().numpy().reshape(-1)
    v = vlines.cpu().numpy().reshape(-1)
    zero, half = np.float32(0), np.float32(0.5)
    rng = np.random.default_rng(seed)
    S = 64 * gather_warps
    mask = (1 << stamp_bits) - 1
    stamps = np.full(mask + 1, -1, np.int64)
    pending = []                 # the open pass's stamps: (hash, commit)
    taken = set()                # the open pass's columns
    room = start = 0             # the open pass: room left, first position
    recent = np.zeros(RECENT, np.int64)
    log = []                     # commit t: (j, price bits, owner before it)
    count = dict(from_lane=0, stale=0, self=0, passes=0)
    acc, t, tail = zero, 0, qcount

    def close():                 # the pass's stamps land at its end
        for hj, tt in pending:
            stamps[hj] = tt
        pending.clear()
        taken.clear()
        count["passes"] += 1

    while t != tail and t < max_bids:
        self_read = snapshot == "random" and rng.random() < 0.25
        u = int(recent[t % RECENT] if self_read and t >= qcount
                and tail - t <= RECENT else q[t % cap])
        j = int(c[u * K])
        if taken and (self_read or room == 0 or j in taken):
            close()
        pk, own = p[j], o[j]
        if self_read:
            count["self"] += 1
            room = 0
        else:
            if not taken:
                room = 32 if snapshot == "stalest" else int(
                    rng.integers(1, 33))
                start = t
            # the lane published before the pass began: c0 <= its start
            lo = max(0, t - S + 1)
            c0 = lo if snapshot == "stalest" else int(
                rng.integers(lo, start + 1))
            for jj, old_p, old_o in reversed(log[c0:]):
                if jj == j:      # the column as it stood after c0 commits
                    pk, own = old_p, old_o
            count["from_lane"] += 1
            if stage >= 2 and stamps[j & mask] >= c0:
                pk, own = p[j], o[j]
                count["stale"] += 1
            room -= 1
        taken.add(j)
        pk = pk + zero
        acc = (acc + pk) + (v[u * K] + zero)
        if stage >= 3 and own >= 0:
            q[tail % cap] = own
            recent[tail % RECENT] = own
            tail += 1
        log.append((j, p[j], o[j]))
        if stage >= 2:
            p[j] = pk + half
            o[j] = u
            pending.append((j & mask, t))
        if self_read:            # a pass of one
            close()
        t += 1
    if taken:
        close()
    return (np.array([t, tail - t], np.int32), np.array([acc], np.float32),
            count)


def ladder_counters(kernel=None):
    """The last launch of ``kernel`` (P16 or P17; default: whichever of
    them launched last): bids taken from a gather lane's slot, of those
    re-read as stale, bids the commit warp read itself, its passes (one
    release fence each), and its clock64 cycles waiting for a lane's slot
    and in all; None before the first launch.  Synchronises."""
    c = (kernel or _last_ladder[0]).counters
    return None if c is None else dict(zip(
        ("from_lane", "stale", "self", "passes", "wait_cycles", "cycles"),
        c.tolist()))


def _ladder_cuda(stage, counts, clines, vlines, q, p, o, K):
    """P16 and P17: the look-ahead kernel with GATHER_WARPS gather warps on
    the queue, the price table as int32 bits and the owner table.  Returns
    stats, acc and the counters (int64 [6])."""
    qcount, max_bids, cap = counts
    dev = clines.device
    lib = _build.load()
    _need(1 <= GATHER_WARPS <= 8, f"gs_ladder: GATHER_WARPS = {GATHER_WARPS} "
          f"outside 1-8")
    counters = torch.empty(6, dtype=torch.int64, device=dev)
    stats = torch.empty(2, dtype=torch.int32, device=dev)
    acc = torch.empty(1, dtype=torch.float32, device=dev)
    _build.check(lib.sslap_probe_ladder(
        stage, clines.data_ptr(), vlines.data_ptr(), K, q.data_ptr(),
        p.data_ptr(), o.data_ptr(), qcount, max_bids, cap, GATHER_WARPS,
        stats.data_ptr(), acc.data_ptr(), counters.data_ptr(),
        _stream(clines)), "gs_ladder")
    return stats, acc, counters


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
        stats, acc, kernel.counters = _ladder_cuda(
            stage, counts, clines, vlines, q, p, o, K)
        _last_ladder[0] = kernel
        return (*tables, stats, acc)

    kernel = ProbeKernel(name, line, "probe_ladder.cu", plain, cuda)
    kernel.counters = None        # its last launch's, on the device
    return kernel


gs_ladder_uni = _ladder_probe("gs_ladder_uni", 838, unified=True)
gs_ladder = _ladder_probe("gs_ladder", 997, unified=False)
_last_ladder = [gs_ladder_uni]   # the ladder probe launched last


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
                  prices=None, first="arange", first_mod=65_536):
    """The ladder probes' construction (probe_mosaic_gs.py:945-958,
    1097-1108) at any size: rng 3; cols sorted, then ``cols[:, 0] =
    arange(n)`` (needs m >= n); vals in [0, 10); line-packed with NL =
    (K + 254) // 128 spare lines; rows 0..n-1 queued; prices 0 (or
    ``prices``), owner -1; tables 128-wide rows.

    ``first`` sets the rows' first columns, where the bids go: "arange"
    (the probe's; no column repeats, nothing is evicted), "mod" (``u mod
    first_mod``: each column hit ~n / first_mod times, and at stage 3 every
    bid after the first ``first_mod`` evicts, so the ring stays long) or
    "three" (rows 0-2 queued alone, all on column 0: at stage 3 a ring of
    two rows, each bid evicting the previous bidder, until ``max_bids``)."""
    if first not in ("arange", "mod", "three"):
        raise ValueError(f"first must be 'arange', 'mod' or 'three', got "
                         f"{first!r}")
    rng = np.random.default_rng(3)
    cols = np.sort(rng.integers(0, m, (n, K)), axis=1).astype(np.int32)
    cols[:, 0] = np.arange(n) % first_mod if first == "mod" else np.arange(n)
    queued = n
    if first == "three":
        cols[:3, 0] = 0
        queued = 3
    vals = (rng.random((n, K)) * 10).astype(np.float32)
    NL = (K + 2 * (LINE - 1)) // LINE
    flatc = np.zeros(((n * K) // LINE + NL) * LINE, np.int32)
    flatv = np.zeros_like(flatc, dtype=np.float32)
    flatc[:n * K] = cols.reshape(-1)
    flatv[:n * K] = vals.reshape(-1)
    up = lambda k: -(-k // LINE) * LINE  # noqa: E731
    counts = (queued, max_bids, cap)
    p0 = np.zeros(m, np.float32) if prices is None else prices
    lines = (flatc.reshape(-1, LINE), flatv.reshape(-1, LINE))
    if unified:
        W = up(max(cap, m))
        state = np.zeros((3, W), np.int32)
        state[0, :queued] = np.arange(queued)
        state[1, :m] = p0.view(np.int32)
        state[2] = -1
        return (counts, *lines, state), dict(K=K, stage=stage)
    q = np.zeros(up(cap), np.int32)
    q[:queued] = np.arange(queued)
    p = np.zeros(up(m), np.float32)
    p[:m] = p0
    o = np.full(up(m), -1, np.int32)
    return ((counts, *lines, q.reshape(-1, LINE), p.reshape(-1, LINE),
             o.reshape(-1, LINE)), dict(K=K, stage=stage))


def store_inputs(n, pairs, seed):
    """An instance of P15 (and P13) at any size, numpy: hbm [2 pairs, 128]
    int32, rows 2r random (first entries of either sign), rows 2r + 1
    random with the last entry making their sum 0 or 1, so every acc + 7
    the loop stores at a position below 96 is a row id in range while
    positions 64-95 read slots it wrote; q [max(n, 128)] int32, q[:n]
    random ids."""
    rng = np.random.default_rng(seed)
    hbm = rng.integers(-2 ** 31, 2 ** 31, (2 * pairs, LINE), dtype=np.int64)
    hbm[1::2, -1] = rng.integers(0, 2, pairs) - hbm[1::2, :-1].sum(axis=1)
    hbm = ((hbm + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
    q = np.zeros(max(n, LINE), np.int32)
    q[:n] = rng.integers(0, pairs, n)
    return hbm, q


def queue_inputs(n, pairs, seed):
    """An instance of P7-P14 at any size, numpy: store_inputs' hbm [2 pairs,
    128] int32 and q (random ids in q[:n], with room for P8's pushes); vbm
    [2 pairs, 128] f32 of integers in [-64, 64) (every partial sum of a row
    exact, so the f32 row sum does not depend on its order); pt [pairs]
    f32 integers and ot [pairs] int32.  ``queue_tables`` puts them in a
    probe's order."""
    hbm, q = store_inputs(n, pairs, seed)
    q = np.concatenate([q, np.zeros(max(0, n + 4 - q.size), np.int32)])
    rng = np.random.default_rng([seed, 1])
    vbm = rng.integers(-64, 64, hbm.shape).astype(np.float32)
    pt = rng.integers(-10 ** 6, 10 ** 6, pairs).astype(np.float32)
    ot = rng.integers(-2 ** 31, 2 ** 31, pairs, dtype=np.int64).astype(
        np.int32)
    return dict(hbm=hbm, q=q, vbm=vbm, pt=pt, ot=ot)


def queue_tables(kernel, tables):
    """The tables of ``queue_inputs`` (a dict) a queue probe takes after its
    scalars, in its order."""
    return tuple(tables[k] for k in kernel.order)


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
