"""Tracking workload: frame-to-frame assignment with warm-started prices.
Counterpart of ``examples/tracking.py``.

Multi-object tracking: every frame, match N tracks to N detections by
(sparse) association cost.  Costs change only slightly between frames, so
the previous frame's price vector is a near-optimal dual warm start: the
auction re-converges in a fraction of the cold rounds.  The solves run in
mode='device' on ``--device`` (the card by default; a missing card
raises).  ``python -m sslap_tpu_torch.benchmarks.tracking`` is the same
workload at scale, with the hybrid engine.

Run:  python -m sslap_tpu_torch.examples.tracking [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from sslap_tpu_torch import AuctionSolver, hopcroft_solve
from sslap_tpu_torch.utils import load_state, save_state


def frame_costs(rng, n, base_pos, jitter=0.02, cand=8):
    """Sparse association costs: each track considers its ``cand`` nearest
    detections by (noisy) position distance."""
    det_pos = base_pos + rng.normal(0, jitter, base_pos.shape)
    order = np.argsort(
        np.abs(base_pos[:, None] - det_pos[None, :]), axis=1)[:, :cand]
    rows = np.repeat(np.arange(n), cand)
    cols = order.ravel()
    # include each track's true detection so a perfect matching exists
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    key = rows.astype(np.int64) * n + cols
    _, idx = np.unique(key, return_index=True)
    rows, cols = rows[idx], cols[idx]
    val = np.abs(base_pos[rows] - det_pos[cols]).astype(np.float32) * 1e3 + 1
    return np.stack([rows, cols], axis=1), val


def main(n: int = 2000, device: str = "cuda", frames: int = 5) -> dict:
    rng = np.random.default_rng(0)
    base_pos = np.sort(rng.random(n))
    out = {"frames": []}

    prices = None
    t0 = time.perf_counter()
    for frame in range(frames):
        loc, val = frame_costs(rng, n, base_pos)
        solver = AuctionSolver(loc=loc, val=val, shape=(n, n),
                               mode="device", cardinality_check=False,
                               device=device)
        # Warm prices carry the learned duals across frames; the full eps
        # schedule re-anneals the (small) cost changes.  (Do NOT warm-start
        # with a tiny eps_start: correcting cost changes of magnitude D at
        # fixed eps takes ~D/eps rounds per contested column.  On the
        # 'hybrid'/'cpu' engines, add warm_mode="fr" when the pattern
        # churns or frames chain: the forward-reverse tightening lowers
        # stale duals to the new market level first.)
        res = solver.solve(warm_prices=prices)
        if frame == 1:
            # fair comparison on the SAME frame: cold vs warm
            cold = AuctionSolver(loc=loc, val=val, shape=(n, n),
                                 mode="device", cardinality_check=False,
                                 device=device).solve()
            out["cold_its_frame1"] = cold["meta"]["its"]
            out["cold_phases_frame1"] = cold["meta"]["phases"]
            print(f"  frame 1 cold rounds {cold['meta']['its']} vs warm "
                  f"{res['meta']['its']} "
                  f"({cold['meta']['its'] / res['meta']['its']:.1f}x fewer)")
        prices = solver.prices
        kind = "cold" if frame == 0 else "warm"
        print(f"frame {frame} ({kind}): objective {res['meta']['obj']:.1f} "
              f"rounds {res['meta']['its']}")
        out["frames"].append({"obj": res["meta"]["obj"],
                              "its": res["meta"]["its"],
                              "phases": res["meta"]["phases"],
                              "sol": res["sol"], "prices": res["prices"]})
    out["seconds"] = time.perf_counter() - t0
    print(f"{frames} frames in {out['seconds']:.2f}s")

    # Prices survive process restarts through the checkpoint utils.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tracking_prices.npz")
        save_state(path, prices, eps=1e-2, extra={"frame": frames - 1})
        restored, meta = load_state(path)
    out["checkpoint_ok"] = bool(np.array_equal(restored, prices))
    print("checkpoint round-trip OK:", out["checkpoint_ok"],
          "| meta:", meta["extra"])

    # Feasibility checks warm-start the same way: seed Hopcroft-Karp with
    # the previous frame's matching (stale edges are sanitized away).
    loc, val = frame_costs(rng, n, base_pos)
    cold_match = hopcroft_solve(loc=loc, shape=(n, n))
    loc2, _ = frame_costs(rng, n, base_pos)
    warm_match = hopcroft_solve(loc=loc2, shape=(n, n), warm=cold_match)
    out["warm_hk_size"] = int((warm_match >= 0).sum())
    print("warm HK matching size:", out["warm_hk_size"], "/", n)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=2000)
    a = ap.parse_args()
    main(n=a.n, device=a.device)
