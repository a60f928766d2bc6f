"""Solve the dense int32 instance of ``chip_smoke.py``'s dense-engine check
with either implementation, on the CPU, and print how its solve ends.

    python3 dense_tail_budget.py {jax,torch} [N ...]

For each N (default 4096) it draws the matrix as ``chip_smoke._dense_engine``
does (``np.random.default_rng(8)``: an N x N float32 matrix first, then the
int32 costs ``integers(1, 1000, (N, N))``), solves the int32 one with
``AuctionSolver(C, mode="hybrid")`` (engine 'auto' takes the dense engine),
and prints one JSON line with the meta keys that say how it ended
(``soln_found``, ``unassigned``, ``its``, ``phases``, ``host_bids``,
``final_eps``) and scipy's objective beside the solver's.  'jax' runs the
reference package ``sslap_tpu`` on JAX's CPU backend; 'torch' runs the port
``sslap_tpu_torch`` with ``device="cpu"`` (the kernels' plain versions).
Each side is imported only when asked for.  At N = 4096 a solve takes
about a minute and 1-2 GiB.
"""

import json
import sys
import time

import numpy as np
from scipy.optimize import linear_sum_assignment


def _solver(impl):
    if impl == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from sslap_tpu import AuctionSolver
        return lambda C: AuctionSolver(C, mode="hybrid")
    if impl == "torch":
        from sslap_tpu_torch import AuctionSolver
        return lambda C: AuctionSolver(C, mode="hybrid", device="cpu")
    raise SystemExit(f"unknown implementation {impl!r}: jax or torch")


def main(argv):
    impl = argv[0] if argv else "jax"
    make = _solver(impl)
    for n in [int(a) for a in argv[1:]] or [4096]:
        rng = np.random.default_rng(8)
        rng.random((n, n))                 # the float32 matrix drawn first
        C = rng.integers(1, 1000, (n, n))
        r, c = linear_sum_assignment(C)
        t0 = time.perf_counter()
        mt = make(C).solve()["meta"]
        secs = time.perf_counter() - t0
        out = {k: mt.get(k) for k in ("engine", "mode", "soln_found",
                                      "unassigned", "its", "phases",
                                      "host_bids", "final_eps", "obj")}
        out.update(impl=impl, n=n, seconds=secs,
                   scipy_obj=int(C[r, c].sum()))
        print(json.dumps(out, default=float), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
