"""Distributed solves: row-sharding one LAP over a mesh of devices.
Counterpart of ``examples/distributed.py``.

Three backends, all drop-in ``auction_solve`` replacements:

  auction_solve_sharded         full-width Jacobi rounds, combines of the
                                [m] bid tables; bit-identical to the
                                unsharded solve.
  auction_solve_sharded_hybrid  per-shard tiered compaction, compact
                                active-set exchanges (collective bytes
                                track the ACTIVE SET, not m), truncated
                                phases, host GS tail; ``overlap=True``
                                additionally pipelines the wide rounds.

The mesh spans every local CUDA device by default.  ``--cuda-shards K``
puts K shards on the one card, ``--cpu-shards K`` builds a mesh of K CPU
shards (the shards of one process take turns; no card needed).

Multi-HOST launch pattern: run the same script once per host, calling
``initialize_multihost(address, num_processes, process_id)`` before
``make_mesh()``; every solver below then works unchanged.  ``python -m
sslap_tpu_torch.parallel.multiproc`` launches such a run on one machine.

Run:  python -m sslap_tpu_torch.examples.distributed
          [--cuda-shards K | --cpu-shards K] [--n 2048]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from sslap_tpu_torch import auction_solve
from sslap_tpu_torch.parallel import auction_solve_sharded, \
    auction_solve_sharded_hybrid, make_mesh


def instance(n: int, seed: int = 7):
    """Sparse instance (8 columns a row) with a planted perfect matching,
    integer costs in [1, 1000)."""
    rng = np.random.default_rng(seed)
    ii = np.repeat(np.arange(n), 8)
    jj = (ii + rng.integers(0, n, ii.size)) % n
    perm = rng.permutation(n)
    loc = np.stack([np.concatenate([ii, np.arange(n)]),
                    np.concatenate([jj, perm])], 1)
    loc = np.unique(loc, axis=0)
    val = rng.integers(1, 1000, len(loc)).astype(np.int32)
    return loc, val


def main(n: int = 2048, devices: Optional[Sequence] = None) -> dict:
    """``devices``: the mesh's entries (default: every local CUDA
    device)."""
    loc, val = instance(n)
    mesh = make_mesh(devices)              # 1-D 'rows' mesh
    dev = mesh.devices[0]
    print(f"mesh: {mesh.shape} over {dev.type}")
    out = {"shards": len(mesh.devices)}

    single = auction_solve(loc=loc, val=val, shape=(n, n), mode="device",
                           cardinality_check=False, device=str(dev))

    # Full-width sharded round: bit-identical to the single-device solve.
    sh = auction_solve_sharded(loc=loc, val=val, shape=(n, n), mesh=mesh,
                               cardinality_check=False)
    assert (sh["sol"] == single["sol"]).all()
    print(f"sharded     obj {sh['meta']['obj']} "
          f"(assignment identical to single-device) "
          f"rounds {sh['meta']['its']}")
    out["single"] = (single["meta"]["obj"], single["meta"]["its"])
    out["sharded"] = (sh["meta"]["obj"], sh["meta"]["its"], sh["sol"])

    # Sharded hybrid: the scale path.  trunc=64 runs the device ladder
    # down to 64 active rows before the host tail, so the compact-exchange
    # tiers engage at this size.
    hy = auction_solve_sharded_hybrid(loc=loc, val=val, shape=(n, n),
                                      mesh=mesh, trunc=64,
                                      cardinality_check=False)
    m = hy["meta"]
    print(f"sharded hyb obj {m['obj']} rounds {m['its']} "
          f"host-tail bids {m['host_bids']}")
    full, sent = m["comm_bytes_fullwidth_equiv"], m["comm_bytes_total"]
    print(f"  collective bytes: {sent / 1e6:.1f} MB vs {full / 1e6:.1f} MB "
          f"full-width-equiv ({full / max(sent, 1):.1f}x less on the wire)")
    out["hybrid"] = (m["obj"], m["its"], m["host_bids"],
                     m["comm_bytes_total"], m["comm_bytes_fullwidth_equiv"])

    # Overlapped variant: wide rounds pipelined one deep (pays off when
    # the [m] combine is comparable to the bid compute).
    ov = auction_solve_sharded_hybrid(loc=loc, val=val, shape=(n, n),
                                      mesh=mesh, trunc=64, overlap=True,
                                      cardinality_check=False)
    assert ov["meta"]["obj"] == hy["meta"]["obj"]
    print(f"overlap=True obj matches; rounds {ov['meta']['its']} "
          f"(vs {m['its']} sync: the pipeline's round-count price)")
    out["overlap"] = (ov["meta"]["obj"], ov["meta"]["its"])

    # Mesh-balanced ladder buffers: narrow-tier compute shrinks with the
    # mesh (~2C/D buffers + local spill rebuilds).  Opt-in: costs trunc=0
    # bit-exactness, never objective optimality.
    bal = auction_solve_sharded_hybrid(loc=loc, val=val, shape=(n, n),
                                       mesh=mesh, trunc=64,
                                       ladder_balance=True,
                                       cardinality_check=False)
    assert bal["meta"]["obj"] == hy["meta"]["obj"]
    print(f"ladder_balance=True obj matches; "
          f"spill rebuilds {bal['meta']['ladder_rebuilds']}, "
          f"collective bytes {bal['meta']['comm_bytes_total']/1e6:.1f} MB")
    out["balance"] = (bal["meta"]["obj"], bal["meta"]["ladder_rebuilds"],
                      bal["meta"]["comm_bytes_total"])
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    shards = ap.add_mutually_exclusive_group()
    shards.add_argument("--cpu-shards", type=int, default=None,
                        help="a mesh of this many CPU shards")
    shards.add_argument("--cuda-shards", type=int, default=None,
                        help="this many shards on the one card")
    ap.add_argument("--n", type=int, default=2048)
    a = ap.parse_args()
    devs = (None if a.cpu_shards is None and a.cuda_shards is None
            else [torch.device("cpu")] * a.cpu_shards if a.cpu_shards
            else [torch.device("cuda")] * a.cuda_shards)
    main(n=a.n, devices=devs)
