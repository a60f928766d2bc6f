"""Time the 1M x 1M headline solve on one CUDA device, in the tree of the
current directory.

    python3 time_headline.py LABEL

Run from the root of a tree of this repository (it imports that tree's
``sslap_tpu_torch`` and ``chip_smoke.make_instance``): builds the headline
instance (bench.py's generator and seed), solves it with
AuctionSolver(mode="hybrid", device="cuda") once cold and four times
cached, and prints one line

    AB LABEL [{"solve": ..., "device_time": ..., "its": ..., ...}, ...]

for the cached solves: solve() wall seconds, the meta timers (seconds),
its and host bids, a hash of (solution, prices) that two trees computing
the same result share, and, where the tree has the ladder kernel, its
per-round cost above and below the one-block tail and their stage A (bid
+ resolve) part in us (``ops.ladder_phase.stats``).  To compare two
trees, run it from each root in turns (A, B, B, A) within one call on
one card.
"""

import hashlib
import json
import sys
import time

import numpy as np
import torch

import chip_smoke as S
from sslap_tpu_torch import AuctionSolver

try:
    from sslap_tpu_torch.ops import ladder_phase
except ImportError:          # a tree from before the ladder kernel
    ladder_phase = None


def _per_round(stats):
    out = {}
    for side in ("grid", "tail"):
        r = max(stats[f"{side}_rounds"], 1)
        out[f"{side}_rounds"] = stats[f"{side}_rounds"]
        out[f"{side}_us"] = stats[f"{side}_ns"] / r / 1e3
        out[f"{side}_a_us"] = stats.get(f"{side}_a_ns", 0) / r / 1e3
    return out


def main(label: str) -> None:
    n = S.N_HEAD
    rr, cc, vv = S.make_instance(n, n, 9, seed=0)
    solver = AuctionSolver(loc=np.stack([rr, cc], 1), val=vv, shape=(n, n),
                           mode="hybrid", device="cuda")
    rows = []
    for rep in range(5):
        if ladder_phase is not None:
            for k in ladder_phase.stats:
                ladder_phase.stats[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver.solve()
        wall = time.perf_counter() - t0
        m = res["meta"]
        digest = hashlib.sha256(res["sol"].tobytes()
                                + res["prices"].tobytes()).hexdigest()[:16]
        row = dict(solve=wall, device_time=m["device_time"],
                   readback_time=m["readback_time"],
                   host_gs_time=m["host_gs_time"], its=m["its"],
                   host_bids=m["host_bids"], phases=m["phases"],
                   hash=digest)
        if ladder_phase is not None:
            row.update(_per_round(ladder_phase.stats))
        if rep:
            rows.append(row)
    print("AB", label, json.dumps(rows), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree")
