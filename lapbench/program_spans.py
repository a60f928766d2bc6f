"""The program's own spans and counters (``sslap_tpu_torch.utils.profiling``),
grouped by request, for the metric readers.

The program times its spans on ``time.perf_counter()``, the clock of the
harness's spans, so each root ``solve`` span of the program is matched to
the harness's ``solve`` span of a request of the window (``req >= 0``)
that contains it, and a request's spans are every span under those
roots, on any thread.  Every function returns None when there is nothing
to read: a program without ``spans()``, no request of the window matched,
or a buffer that has wrapped past the window's start (its oldest span
closed after the window began, and it is full).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional


def _recorder():
    try:
        from sslap_tpu_torch.utils import profiling as prof
    except ImportError:
        return None
    return prof if callable(getattr(prof, "spans", None)) else None


def requests(run) -> Optional[List[List[dict]]]:
    """The spans of each request of the window that the program's root
    spans cover, one list a request, in the window's order."""
    prof = _recorder()
    if prof is None:
        return None
    recs = prof.spans()
    solves = run.window_spans("solve")
    if not recs or not solves:
        return None
    start = min(s["t0"] for s in solves)
    if len(recs) >= prof.MAX_SPANS and min(r["t1"] for r in recs) >= start:
        return None
    by_root: Dict[int, List[dict]] = {}
    for r in recs:
        by_root.setdefault(r["root"], []).append(r)
    roots = [r for r in recs if r["parent"] is None and r["name"] == "solve"]
    out = []
    for s in sorted(solves, key=lambda s: s["t0"]):
        mine = [r for r in roots if s["t0"] <= r["t0"] and r["t1"] <= s["t1"]]
        if mine:
            out.append([x for r in mine for x in by_root[r["id"]]])
    return out or None


def mean_over_requests(run, per_request: Callable[[List[dict]], float]
                       ) -> Optional[float]:
    """``per_request`` of each request's spans, mean over the requests."""
    reqs = requests(run)
    if reqs is None:
        return None
    vals = [per_request(spans) for spans in reqs]
    return sum(vals) / len(vals)


def total_s(spans: List[dict], name: str) -> float:
    """Seconds in the spans named ``name`` (summed over threads)."""
    return sum(s["t1"] - s["t0"] for s in spans if s["name"] == name)


def shard_mean(spans: List[dict], key: str) -> float:
    """Counter ``key`` of the ``shard_pass`` spans, mean over the shards."""
    vals = [s["counts"].get(key, 0) for s in spans
            if s["name"] == "shard_pass"]
    return sum(vals) / len(vals) if vals else 0.0


def unspanned_s(spans: List[dict]) -> float:
    """Seconds of the roots not covered by any other span on the root's
    thread (the union of those spans, cut to the root)."""
    out = 0.0
    for root in (s for s in spans if s["parent"] is None):
        lo, hi = root["t0"], root["t1"]
        ivs = sorted((max(s["t0"], lo), min(s["t1"], hi)) for s in spans
                     if s is not root and s["root"] == root["id"]
                     and s["thread"] == root["thread"])
        covered, end = 0.0, lo
        for a, b in ivs:
            a = max(a, end)
            if b > a:
                covered += b - a
                end = b
        out += (hi - lo) - covered
    return out
