"""The yardstick: the table of peaks, the bytes a device pass must move,
and the reduction of a profiler window to busy time, idle share, the top
device operations and the labelled idle gaps.  Nothing here imports the
program."""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Published peaks (NVIDIA's data sheet, SXM part, at its 700 W limit).
# Shares are stated against these, with the card's power limit beside.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "memory_bytes": 80e9},
}
DEFAULT_KIND = "NVIDIA H100 80GB HBM3"


def hbm_bytes_per_s(kind: str) -> float:
    return PEAKS.get(kind, PEAKS[DEFAULT_KIND])["hbm_bytes_per_s"]


def pass_bytes(n: int, m: int, nnz: int, instances: int = 1) -> int:
    """Bytes a device pass over ``instances`` n x m instances with ``nnz``
    entries in all must move, whatever its kernels do: every input byte
    read once (each entry's int32 column and float32 value, the int32 row
    counts, the float32 prices) and every output byte written once (the
    float32 prices, the int32 assignment)."""
    return 8 * int(nnz) + int(instances) * (4 * int(n) + 4 * int(m)
                                            + 4 * int(m) + 4 * int(n))


def short_name(name: str, limit: int = 120) -> str:
    """A kernel's name without the return type, cut to ``limit``."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= limit else name[:limit - 3] + "..."


def union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merged, sorted union of [start, end) intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(merged: Sequence[Tuple[int, int]], lo: int, hi: int) -> int:
    """Length of [lo, hi) that the merged intervals cover."""
    return sum(max(0, min(e, hi) - max(s, lo)) for s, e in merged)


def gaps(merged: Sequence[Tuple[int, int]], lo: int, hi: int
         ) -> List[Tuple[int, int]]:
    """The uncovered stretches of [lo, hi)."""
    out, t = [], lo
    for s, e in merged:
        if e <= lo or s >= hi:
            continue
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out


def phases(spans: Sequence[dict], first_last: Dict[int, Tuple[int, int]]
           ) -> List[Tuple[int, int, str]]:
    """What the host was doing, as labelled intervals: each harness span
    by its name, and a request's solve split at its first and last device
    operation into prep (the pre-check, transforms, tables), device_pass,
    and tail (read back, GS tail, objective)."""
    out = []
    for sp in spans:
        if sp["name"] != "solve":
            out.append((sp["t0"], sp["t1"], sp["name"]))
            continue
        fl = first_last.get(sp["req"])
        if fl is None:
            out.append((sp["t0"], sp["t1"], "prep"))
            continue
        a, b = max(sp["t0"], min(fl[0], sp["t1"])), min(fl[1], sp["t1"])
        out += [(sp["t0"], a, "prep"), (a, max(a, b), "device_pass"),
                (max(a, b), sp["t1"], "tail")]
    return sorted(p for p in out if p[1] > p[0])


def labelled(gap_list: Sequence[Tuple[int, int]],
             ph: Sequence[Tuple[int, int, str]]) -> List[Tuple[str, int]]:
    """Each idle gap cut at the host phases it spans: (label, ns)."""
    out = []
    for g0, g1 in gap_list:
        t = g0
        for p0, p1, name in ph:
            lo, hi = max(g0, p0), min(g1, p1)
            if hi <= lo:
                continue
            if lo > t:
                out.append(("between_requests", lo - t))
            out.append((name, hi - lo))
            t = hi
        if t < g1:
            out.append(("between_requests", g1 - t))
    return out


def reduce_trace(events: Sequence[dict], spans: Sequence[dict],
                 window: Tuple[int, int], devices: Sequence[int]) -> dict:
    """Reduce device events (``dev``, ``name``, ``t0``, ``t1`` in ns,
    ``copy`` for memcpy/memset) and harness spans (``name``, ``req``,
    ``t0``, ``t1`` in the same clock) over ``window``.

    Returns the busy seconds (mean over the devices), the kernel seconds
    (summed), the idle share, the top ten device operations by time and
    the ten longest idle gaps of the first device, cut at and labelled by
    what the host was doing."""
    lo, hi = window
    win_s = (hi - lo) / 1e9
    busy, kern = {}, {}
    by_name: Dict[str, float] = {}
    merged_of = {}
    for d in devices:
        evs = [e for e in events if e["dev"] == d
               and e["t1"] > lo and e["t0"] < hi]
        merged = union((e["t0"], e["t1"]) for e in evs)
        merged_of[d] = merged
        busy[d] = covered(merged, lo, hi) / 1e9
        kern[d] = sum(min(e["t1"], hi) - max(e["t0"], lo)
                      for e in evs if not e["copy"]) / 1e9
        for e in evs:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + \
                (min(e["t1"], hi) - max(e["t0"], lo)) / 1e9
    solves = [sp for sp in spans if sp["name"] == "solve"]
    first_last: Dict[int, Tuple[int, int]] = {}
    all_evs = sorted((e["t0"], e["t1"]) for e in events)
    starts = [s for s, _ in all_evs]
    for sp in solves:
        a = bisect.bisect_left(starts, sp["t0"])
        b = bisect.bisect_left(starts, sp["t1"])
        if b > a:
            first_last[sp["req"]] = (starts[a],
                                     max(e for _, e in all_evs[a:b]))
    pieces = labelled(gaps(merged_of[devices[0]], lo, hi),
                      phases(spans, first_last))
    idle_gaps = [[name, ns / 1e9]
                 for name, ns in sorted(pieces, key=lambda p: -p[1])[:10]]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top = [(short_name(k), v) for k, v in top]
    n_dev = len(devices)
    return {
        "window_s": win_s,
        "busy_s": sum(busy.values()) / n_dev,
        "kernel_s_total": sum(kern.values()),
        "idle_pct": sum(100.0 * (1.0 - busy[d] / win_s)
                        for d in devices) / n_dev if win_s > 0 else None,
        "device_ops": [[k, v] for k, v in top],
        "idle_gaps": idle_gaps,
    }


def profiler_events(prof) -> Tuple[List[dict], Dict[str, List[Tuple[int,
                                                                    int]]]]:
    """Device events and user annotations of a finished
    ``torch.profiler.profile``, in its own clock (ns)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev_events, notes = [], {}
    for e in prof.profiler.kineto_results.events():
        t0 = int(e.start_ns())
        t1 = t0 + int(e.duration_ns())
        if e.device_type() == cuda:
            name = e.name()
            if e.is_user_annotation() or name.startswith("lapbench/"):
                continue            # a host range drawn on the device row
            dev_events.append({
                "dev": int(e.device_index()), "name": name, "t0": t0,
                "t1": t1,
                "copy": name.startswith(("Memcpy", "Memset", "memcpy",
                                         "memset"))})
        elif e.is_user_annotation() and e.name().startswith("lapbench/"):
            notes.setdefault(e.name(), []).append((t0, t1))
    return dev_events, notes


def spans_from_notes(notes: Dict[str, List[Tuple[int, int]]]
                     ) -> Tuple[List[dict], Optional[Tuple[int, int]]]:
    """Harness spans from the annotations ``lapbench/<name>/<req>`` and
    the window from ``lapbench/window``."""
    spans, window = [], None
    for key, ivs in notes.items():
        parts = key.split("/")
        if parts[1] == "window":
            window = ivs[0]
            continue
        for t0, t1 in ivs:
            spans.append({"name": parts[1], "req": int(parts[2]),
                          "t0": t0, "t1": t1})
    spans.sort(key=lambda s: s["t0"])
    return spans, window
