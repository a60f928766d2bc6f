"""The port stands alone: importing ``sslap_tpu_torch`` (the batched,
feasibility-seed, parallel, candidate, calibrate and utils modules, the
tracking harness, the differential fuzz and the examples included) and
everything ``chip_smoke.py`` imports, then solving a small instance, a
small batch, a sharded instance (plain and sharded hybrid), one with
engine='candidates', two tracking families and one case of each fuzz
family on the CPU through the native host runtime, with the device seed
of the Hopcroft-Karp check (the overlapped, scaling and multi-process
modules imported too), loads no jax and no file of the JAX package
(``sslap_tpu/``), and the port's native library is its own build under
``sslap_tpu_torch/_build/native/``.  Checked in a fresh interpreter (this
test process has jax loaded by the test harness).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import json, sys
import numpy as np
import chip_smoke  # noqa: F401  (its imports)
import sslap_tpu_torch as P
import sslap_tpu_torch.batch as PB
import sslap_tpu_torch.dense_batch  # noqa: F401
import torch
from sslap_tpu_torch import _native, feasibility, parallel
from sslap_tpu_torch import calibrate, candidate, utils
from sslap_tpu_torch.utils import checkpoint, liveness, profiling
from sslap_tpu_torch.benchmarks import fuzz
from sslap_tpu_torch.benchmarks import tracking as harness
from sslap_tpu_torch.examples import basic, distributed, tracking
rng = np.random.default_rng(0)
n, k = 300, 6
rr = np.concatenate([np.repeat(np.arange(n), k), np.arange(n)])
cc = np.concatenate([rng.integers(0, n, n * k), rng.permutation(n)])
_, idx = np.unique(rr * n + cc, return_index=True)
loc = np.stack([rr[idx], cc[idx]], 1)
val = rng.integers(1, 100, idx.shape[0])
res = P.AuctionSolver(loc=loc, val=val, shape=(n, n), mode="hybrid",
                      device="cpu").solve()
batch = PB.stack_problems([P.from_coo(loc, val, shape=(n, n))] * 2)
_, metas = PB.auction_solve_batched(batch, mode="hybrid", device="cpu")
sharded = parallel.auction_solve_sharded(
    loc=loc, val=val, shape=(n, n), max_iter=50,
    mesh=parallel.make_mesh([torch.device("cpu")] * 2))
hybrid = parallel.auction_solve_sharded_hybrid(
    loc=loc, val=val, shape=(n, n),
    mesh=parallel.make_mesh([torch.device("cpu")] * 2))
cand = P.AuctionSolver(loc=loc, val=val, shape=(n, n), mode="device",
                       engine="candidates", device="cpu").solve()
records, _ = harness.run_families(n=300, frames=1, families="AB",
                                  device="cpu")
fuzzed = fuzz.sweep(fuzz.case_list(0, 5, "all"), "cpu",
                    log=lambda *a: None)
seeded = feasibility.is_feasible(P.from_coo(loc, val, shape=(n, n)),
                                 device_seed=True, device="cpu")
print(json.dumps({
    "modules": {name: getattr(mod, "__file__", None)
                for name, mod in list(sys.modules.items())},
    "runtime": [_native._build.__file__, _native.gs_host.__file__],
    "native": _native.native_available(),
    "native_lib": getattr(_native._lib, "_name", None),
    "soln_found": res["meta"]["soln_found"]
    and all(mt["soln_found"] for mt in metas) and seeded
    and sharded["meta"]["n_shards"] == 2 and hybrid["meta"]["soln_found"]
    and cand["meta"]["soln_found"] and calibrate.crossover() == 500_000
    and all(r.get("found", True) for r in records)
    and not fuzzed["failures"],
}))
"""


def test_port_loads_nothing_of_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["soln_found"]
    names = got["modules"]
    assert not [m for m in names if m == "jax" or m.startswith(
        ("jax.", "jaxlib"))]
    assert not [m for m in names if m == "sslap_tpu" or m.startswith(
        "sslap_tpu.")]
    ref = str(ROOT / "sslap_tpu") + os.sep
    assert not [f for f in list(names.values()) + got["runtime"]
                if f and f.startswith(ref)]
    assert "sslap_tpu_torch.native.build" in names
    assert "sslap_tpu_torch.batch" in names
    assert "sslap_tpu_torch.dense_batch" in names
    assert "sslap_tpu_torch.gs_host" in names
    assert "sslap_tpu_torch.feasibility_device" in names
    assert "sslap_tpu_torch.parallel.sharded" in names
    assert "sslap_tpu_torch.parallel.overlap" in names
    assert "sslap_tpu_torch.parallel.scaling" in names
    assert "sslap_tpu_torch.parallel.multiproc" in names
    assert "sslap_tpu_torch.parallel.sharded_compact" in names
    for mod in ("candidate", "calibrate", "utils", "utils.checkpoint",
                "utils.liveness", "utils.profiling", "benchmarks.tracking",
                "benchmarks.fuzz",
                "examples.basic", "examples.tracking",
                "examples.distributed"):
        assert f"sslap_tpu_torch.{mod}" in names
    if got["native"]:
        lib = Path(got["native_lib"]).resolve()
        assert lib.parent == ROOT / "sslap_tpu_torch" / "_build" / "native"
