"""Basic usage of the port: dense and sparse solves, feasibility, modes.
Counterpart of ``examples/basic.py``, with one more line: the sparse
instance solved with mode='hybrid', whose device rounds run on
``--device``.

Run:  python -m sslap_tpu_torch.examples.basic [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from sslap_tpu_torch import InfeasibleError, auction_solve, hopcroft_solve


def sparse_instance(n: int, seed: int = 0):
    """Random sparse costs (6 columns a row) plus a planted perfect
    matching, de-duplicated; integer costs in [1, 1000)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), 6)
    cols = rng.integers(0, n, rows.shape[0])
    rr = np.concatenate([rows, np.arange(n)])
    cc = np.concatenate([cols, rng.permutation(n)])
    key = rr.astype(np.int64) * n + cc
    _, idx = np.unique(key, return_index=True)
    loc = np.stack([rr[idx], cc[idx]], axis=1)
    val = rng.integers(1, 1000, loc.shape[0])
    return loc, val


def main(n: int = 500, device: str = "cuda") -> dict:
    out = {}
    # --- dense: negative entries are forbidden assignments -----------------
    C = np.array([[3.0, 1.0, -1.0],
                  [2.0, -1.0, 5.0],
                  [-1.0, 4.0, 2.0]])
    res = auction_solve(C, device=device)        # minimize by default
    print("dense min:", res["sol"], "objective:", res["meta"]["obj"])
    out["dense_min"] = (res["sol"].tolist(), res["meta"]["obj"])

    res = auction_solve(C, problem="max", device=device)
    print("dense max:", res["sol"], "objective:", res["meta"]["obj"])
    out["dense_max"] = (res["sol"].tolist(), res["meta"]["obj"])

    # --- sparse COO --------------------------------------------------------
    loc, val = sparse_instance(n)
    res = auction_solve(loc=loc, val=val, shape=(n, n), device=device)
    print(f"sparse {n}x{n}: objective {res['meta']['obj']} "
          f"in {res['meta']['time']:.3f}s (mode {res['meta'].get('mode')})")
    out["sparse"] = (res["meta"]["obj"], res["meta"].get("mode"))

    # the same instance with its device rounds on `device`
    res = auction_solve(loc=loc, val=val, shape=(n, n), mode="hybrid",
                        device=device)
    print(f"sparse {n}x{n}, mode='hybrid' on {device}: objective "
          f"{res['meta']['obj']} in {res['meta']['its']} device rounds")
    out["sparse_hybrid"] = (res["meta"]["obj"], res["meta"]["its"],
                            res["sol"])

    # --- standalone Hopcroft-Karp maximum matching (structure only) --------
    match = hopcroft_solve(loc=loc, shape=(n, n))
    print("max matching size:", int((match >= 0).sum()), "/", n)
    out["matching"] = int((match >= 0).sum())

    # --- infeasibility is detected, not hung -------------------------------
    bad = np.array([[5.0, -1.0],
                    [7.0, -1.0]])                # both rows need column 0
    try:
        auction_solve(bad, device=device)
    except InfeasibleError as e:
        out["infeasible"] = str(e).split("(")[0].strip()
        print("infeasible detected:", out["infeasible"])
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=500)
    a = ap.parse_args()
    main(n=a.n, device=a.device)
