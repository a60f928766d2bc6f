"""One request of a benchmark cell under ``utils.profile_trace``, and what
its Chrome trace shows: the program's ``sslap/`` ranges and the threads
they came from, the first card's longest idle gaps inside the request,
each split by the innermost program range on the calling thread under
each instant, and the program's own spans of the request (seconds by
name, the shards' counters).

    python3 tools/span_timeline.py --workload sparse1M.cold --seed 7

from the root of a checkout, on a machine with the cell's cards.  Prints
one JSON line.  The trace goes to a temporary directory and is removed,
unless ``--keep DIR`` names one.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from lapbench import harness, yardstick  # noqa: E402
from lapbench.drivers import Driver, Spans  # noqa: E402
from sslap_tpu_torch.utils import profiling as prof  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def under(ranges, a, b) -> dict:
    """Seconds of [a, b) by the innermost of ``ranges`` (name, t0, t1, in
    us) that holds each instant; None where none does."""
    cuts = sorted({a, b} | {t for r in ranges for t in r[1:]
                            if a < t < b})
    out: dict = {}
    for x, y in zip(cuts, cuts[1:]):
        mid = (x + y) / 2
        held = [r for r in ranges if r[1] <= mid <= r[2]]
        name = min(held, key=lambda r: r[2] - r[1])[0] if held else None
        out[name] = out.get(name, 0.0) + (y - x) / 1e6
    return out


def read_trace(path: str, top: int = 5) -> dict:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    # the host ranges (the profiler draws each on the card's row too)
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith("sslap/")]
    by_name: dict = {}
    for e in ranges:
        d = by_name.setdefault(e["name"], {"n": 0, "tids": set()})
        d["n"] += 1
        d["tids"].add(e["tid"])
    roots = [e for e in ranges if e["name"] == "sslap/solve"]
    if not roots:
        return {"ranges": {}, "gaps": []}
    root = max(roots, key=lambda e: e["dur"])
    lo, hi, main = root["ts"], root["ts"] + root["dur"], root["tid"]
    mine = [(e["name"][len("sslap/"):], e["ts"], e["ts"] + e["dur"])
            for e in ranges if e["tid"] == main]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    first = min((e["pid"] for e in dev), default=None)
    merged = yardstick.union((e["ts"], e["ts"] + e["dur"]) for e in dev
                             if e["pid"] == first)
    idle = sorted(yardstick.gaps(merged, lo, hi), key=lambda g: g[0] - g[1])
    return {
        "ranges": {k: {"n": v["n"], "threads": len(v["tids"]),
                       "main_thread": main in v["tids"]}
                   for k, v in sorted(by_name.items())},
        "request_s": (hi - lo) / 1e6,
        "device_busy_s": yardstick.covered(merged, lo, hi) / 1e6,
        "gaps": [{"s": (b - a) / 1e6, "at_s": (a - lo) / 1e6,
                  "under": under(mine, a, b)} for a, b in idle[:top]],
    }


def program_summary(recs) -> dict:
    secs: dict = {}
    shards = []
    for r in recs:
        secs[r["name"]] = secs.get(r["name"], 0.0) + r["t1"] - r["t0"]
        if r["name"] == "shard_pass":
            shards.append(dict(r["counts"], rank=r["rank"],
                               s=r["t1"] - r["t0"]))
    return {"spans": len(recs), "seconds": secs,
            "shards": sorted(shards, key=lambda s: s["rank"])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--keep", default=None)
    args = ap.parse_args()
    spec = harness.load_cell(args.workload)
    chips = int(spec["cell"]["chips"])
    driver = Driver(spec["config"], spec["traffic"], args.seed,
                    device="cuda", chips=chips)
    spans = Spans()
    driver.request(-1, spans)                    # warm-up: builds, caches
    for d in range(chips):
        torch.cuda.synchronize(d)
    out = args.keep or tempfile.mkdtemp(prefix="span_timeline_")
    prof.clear()
    t0 = time.perf_counter()
    with prof.profile_trace(out):
        rec = driver.request(0, spans)
    wall = time.perf_counter() - t0
    recs = prof.spans()
    t_read = time.perf_counter()
    (path,) = glob.glob(os.path.join(out, "trace_*.json"))
    size = os.path.getsize(path)
    result = {"workload": args.workload, "seed": args.seed,
              "kind": torch.cuda.get_device_name(0),
              "torch": torch.__version__,
              "all_threads": prof._all_threads_config() is not None,
              "found": all(rec["found"]), "wall_s": wall,
              "trace_bytes": size, **read_trace(path),
              "program": program_summary(recs)}
    result["read_s"] = time.perf_counter() - t_read
    if not args.keep:
        shutil.rmtree(out, ignore_errors=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
