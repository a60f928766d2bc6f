"""Multi-process runs of the distributed solves: N processes joined by
``torch.distributed`` into one group, each driving its shards of one
process-spanning mesh.  Counterpart of ``benchmarks/multiproc_sim.py``.

    python -m sslap_tpu_torch.parallel.multiproc [--backend sharded|
        overlapped|sharded_hybrid|batched] [--n 256] [--k 8] [--nproc 2]
        [--local-devices 1] [--device cuda|cpu] [--dist-backend gloo]
        [--instrument] [--problem PATH.npz --max-iter R] [--timeout 300]
        [--out PATH.npz]

The launcher binds port 0 for a free coordinator port (so concurrent
launchers never collide), starts the workers, waits for them up to
``--timeout`` seconds in all, kills them and prints their output tails if
they hang, and re-prints worker 0's report (one JSON line).  Each worker
pins its torch threads to ``OMP_NUM_THREADS`` (1 by default), calls
``initialize_multihost``, builds the same instance from the seed (the SPMD
contract: every process holds the same inputs), solves it over
``make_mesh([device] * local_devices)``, which spans every process, and
compares the objective with scipy's.  ``--out`` saves worker 0's solution
(npz) for a caller to compare with a one-process run; the report carries
worker 0's kernel launches (K1, K2, its resolve launch alone, the fused
key commit).  Exit code 0 iff
every worker's objectives matched.  The workers solve on the card unless
``--device cpu`` is given.  On one card, keep ``--dist-backend gloo``
(every shard on that card): NCCL refuses two ranks on one card, so under
``--dist-backend nccl`` worker w takes cards w * L .. w * L + L - 1
(L = ``--local-devices``), one a shard.  With ``sharded_hybrid`` every worker
runs the host Gauss-Seidel tail on the replicated prices, as the
reference's processes do.

``--problem`` instead solves a saved ELL problem and eps schedule
(``save_problem``) through ``solve_ell_overlapped`` or
``sharded_solve_ell`` for at most ``--max-iter`` rounds, and times the
solve alone, the devices synchronised around it (``solve_s``,
``ms_per_round``); there is no objective to check, so exit code 0 means
the solve ran on every worker.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_instance(n: int, k: int, seed: int):
    """Sparse n x n instance with a planted perfect matching and integer
    costs in [1, 1000) (``benchmarks/multiproc_sim.py``'s generator):
    (loc, val)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    cols = rng.integers(0, n, size=n * k)
    perm = rng.permutation(n)
    rows = np.concatenate([rows, np.arange(n, dtype=np.int64)])
    cols = np.concatenate([cols, perm])
    vals = rng.integers(1, 1000, size=rows.shape[0])
    _, first = np.unique(rows * n + cols, return_index=True)
    first.sort()
    return np.stack([rows[first], cols[first]], axis=1), vals[first]


def scipy_objective(loc, val, n: int) -> float:
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import min_weight_full_bipartite_matching
    sp = csr_matrix((val.astype(np.float64), (loc[:, 0], loc[:, 1])),
                    shape=(n, n))
    r, c = min_weight_full_bipartite_matching(sp)
    return float(sp[r, c].sum())


def batch_instances(n: int, k: int, seed: int, B: int):
    """The batched backend's B instances (seeds seed .. seed + B - 1), as
    (seed, ELLProblem)."""
    from sslap_tpu_torch import ingest
    return [(seed + b, ingest.from_coo(*build_instance(n, k, seed + b),
                                       shape=(n, n), pad_to=k + 8))
            for b in range(B)]


def save_problem(path, cols, vals_t, valid, nvalid, p0, eps0, eps_min,
                 theta, bigp, theta_tail) -> None:
    """Write an ELL problem (host arrays [n, K], ``vals_t`` the transformed
    values), its start prices [m] and eps schedule for ``--problem``."""
    np.savez(path, cols=cols, vals_t=vals_t, valid=valid, nvalid=nvalid,
             p0=p0, eps0=eps0, eps_min=eps_min, theta=theta, bigp=bigp,
             theta_tail=theta_tail)


def _synchronize(devices) -> None:
    import torch
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def solve_problem(args, devices):
    """``--problem``: the saved problem's solve over ``make_mesh(devices)``
    (which spans every process), timed alone.  Returns (report, arrays)."""
    import torch
    from sslap_tpu_torch import parallel as PP
    from sslap_tpu_torch.ingest import ELLProblem
    from sslap_tpu_torch.parallel.mesh import fetch_global
    with np.load(args.problem) as z:
        a = dict(z)
    n, m = a["cols"].shape[0], a["p0"].shape[0]
    sched = [a[k].item() for k in ("eps0", "eps_min", "theta")]
    sched += [args.max_iter, a["bigp"].item()]
    mesh = PP.make_mesh(devices)
    for d in set(devices):                 # the context, before the clock
        torch.zeros(1, device=d)
    _synchronize(devices)
    t0 = time.perf_counter()
    if args.backend == "overlapped":
        res = PP.solve_ell_overlapped(
            a["cols"], a["vals_t"], a["valid"], a["nvalid"], mesh, a["p0"],
            *sched, theta_tail=a["theta_tail"].item())
    else:
        prob = ELLProblem(cols=a["cols"], vals=a["vals_t"], valid=a["valid"],
                          nvalid=a["nvalid"], n=n, m=m)
        res = PP.sharded_solve_ell(prob, a["vals_t"], mesh, a["p0"], *sched,
                                   n, theta_tail=a["theta_tail"].item())
    _synchronize(devices)
    solve_s = time.perf_counter() - t0
    sigma = fetch_global(res.sigma)
    report = {"ok": True, "backend": args.backend, "n": n,
              "n_shards": len(mesh.devices), "rounds": res.rounds,
              "phases": res.phases, "unassigned": res.unassigned,
              "final_eps": float(res.final_eps), "solve_s": solve_s,
              "ms_per_round": 1e3 * solve_s / max(res.rounds, 1)}
    return report, dict(sol=sigma, prices=fetch_global(res.prices),
                        its=res.rounds, phases=res.phases,
                        unassigned=res.unassigned,
                        final_eps=float(res.final_eps))


def worker(args) -> int:
    import torch
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    from sslap_tpu_torch.parallel.mesh import initialize_multihost, \
        make_mesh, process_count
    devices = [torch.device(args.device)] * args.local_devices
    if args.dist_backend == "nccl":
        # a card per shard: worker w takes cards w * L .. w * L + L - 1
        devices = [torch.device("cuda", args.worker * args.local_devices + i)
                   for i in range(args.local_devices)]
        torch.cuda.set_device(devices[0])
    initialize_multihost(f"localhost:{args.port}", args.nproc, args.worker,
                         backend=args.dist_backend, timeout=args.timeout)
    if process_count() != args.nproc:
        raise RuntimeError("the process group did not form")
    out = {}
    t0 = time.perf_counter()
    if args.problem:
        report, out = solve_problem(args, devices)
        solve_s, ok = report["solve_s"], report["ok"]
    elif args.backend == "batched":
        from sslap_tpu_torch.batch import auction_solve_batched, \
            stack_problems
        inst = batch_instances(args.n, args.k, args.seed,
                               2 * args.nproc * args.local_devices)
        sols, metas = auction_solve_batched(
            stack_problems([p for _, p in inst]), mode="device",
            mesh=make_mesh(devices, "batch"))
        solve_s = time.perf_counter() - t0
        oracles = [scipy_objective(*build_instance(args.n, args.k, s),
                                   args.n) for s, _ in inst]
        objs = [mt["obj"] for mt in metas]
        ok = all(mt["soln_found"] and float(o) == w
                 for mt, o, w in zip(metas, objs, oracles))
        report = {"ok": ok, "backend": "batched", "n": args.n,
                  "B": len(inst), "objs_match": sum(
                      o is not None and float(o) == w
                      for o, w in zip(objs, oracles))}
        out.update(sols=sols, its=[mt["its"] for mt in metas],
                   phases=[mt["phases"] for mt in metas],
                   objs=[np.nan if o is None else float(o) for o in objs])
    else:
        from sslap_tpu_torch.parallel import auction_solve_overlapped, \
            auction_solve_sharded, auction_solve_sharded_hybrid
        loc, val = build_instance(args.n, args.k, args.seed)
        kw = {} if args.backend == "sharded_hybrid" else dict(
            instrument=args.instrument)
        fn = {"sharded": auction_solve_sharded,
              "overlapped": auction_solve_overlapped,
              "sharded_hybrid": auction_solve_sharded_hybrid}[args.backend]
        res = fn(loc=loc, val=val, shape=(args.n, args.n), mesh=make_mesh(
            devices), **kw)
        solve_s = time.perf_counter() - t0
        mt = res["meta"]
        want = scipy_objective(loc, val, args.n)
        ok = bool(mt["soln_found"]) and float(mt["obj"]) == want
        report = {"ok": ok, "backend": args.backend, "n": args.n,
                  "nnz": int(loc.shape[0]), "n_shards": mt["n_shards"],
                  "obj": mt["obj"], "scipy_obj": want, "rounds": mt["its"],
                  "phases": mt["phases"], "final_eps": mt["final_eps"]}
        report.update({k: mt[k] for k in (
            "round_s", "compute_s", "comm_s", "comm_fraction",
            "nnz_imbalance", "tier_rounds", "host_bids", "ladder_rebuilds",
            "comm_bytes_total") if k in mt})
        out.update(sol=res["sol"], prices=res["prices"], its=mt["its"],
                   phases=mt["phases"], final_eps=mt["final_eps"],
                   obj=mt["obj"], **{k: mt[k] for k in (
                       "tier_rounds", "host_bids") if k in mt})
    from sslap_tpu_torch.ops import bid_topk, commit
    from sslap_tpu_torch.ops.commit import commit_keys, resolve
    report.update(nproc=args.nproc, devices_per_proc=args.local_devices,
                  device=args.device, dist_backend=args.dist_backend,
                  solve_s=solve_s, launches={
                      f.__name__: f.launches
                      for f in (bid_topk, commit, resolve, commit_keys)})
    if args.worker == 0:
        if args.out:
            np.savez(args.out, **out)
        print(json.dumps(report), flush=True)
    else:
        print(f"[worker {args.worker}] ok={ok}", flush=True)
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0 if ok else 1


def launcher(args) -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env.setdefault("OMP_NUM_THREADS", "1")
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                   if p])
    procs = []
    for pid in range(args.nproc):
        cmd = [sys.executable, "-m", "sslap_tpu_torch.parallel.multiproc",
               "--worker", str(pid), "--port", str(port),
               "--backend", args.backend, "--n", str(args.n),
               "--k", str(args.k), "--nproc", str(args.nproc),
               "--local-devices", str(args.local_devices),
               "--device", args.device, "--dist-backend", args.dist_backend,
               "--seed", str(args.seed), "--timeout", str(args.timeout)]
        if args.instrument:
            cmd.append("--instrument")
        if args.out:
            cmd += ["--out", args.out]
        if args.problem:
            cmd += ["--problem", args.problem, "--max-iter",
                    str(args.max_iter)]
        procs.append(subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=_ROOT, env=env))
    rc = 0
    deadline = time.monotonic() + args.timeout
    try:
        for pid, p in enumerate(procs):
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            if pid == 0 or p.returncode != 0:
                sys.stdout.write(out)
            rc |= p.returncode
    except subprocess.TimeoutExpired:
        sys.stdout.write("TIMEOUT: killing workers\n")
        for p in procs:
            p.kill()
        for pid, p in enumerate(procs):
            out, _ = p.communicate()
            sys.stdout.write(f"--- worker {pid} ---\n{out[-2000:]}")
        rc = 2
    sys.stdout.flush()
    return rc


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="sharded",
                    choices=("sharded", "overlapped", "sharded_hybrid",
                             "batched"))
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--local-devices", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="the workers' device (default: the card)")
    ap.add_argument("--dist-backend", default="gloo",
                    choices=("gloo", "nccl"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--instrument", action="store_true",
                    help="sharded/overlapped: add the comm/compute "
                         "breakdown to the report")
    ap.add_argument("--problem", default=None,
                    help="sharded/overlapped: solve this save_problem npz "
                         "instead of the generated instance")
    ap.add_argument("--max-iter", type=int, default=None,
                    help="with --problem: the round cap")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", type=int, default=None,
                    help="internal: this worker's process id")
    ap.add_argument("--port", type=int, default=None,
                    help="internal: the coordinator port")
    args = ap.parse_args(argv)
    if args.problem and (args.backend in ("batched", "sharded_hybrid")
                         or args.max_iter is None or args.instrument):
        ap.error("--problem takes the sharded or overlapped backend, "
                 "--max-iter and no --instrument")
    if args.instrument and args.backend in ("batched", "sharded_hybrid"):
        ap.error("--instrument takes the sharded or overlapped backend")
    if args.dist_backend == "nccl" and args.device != "cuda":
        ap.error("--dist-backend nccl takes --device cuda")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.worker is not None:
        return worker(args)
    return launcher(args)


if __name__ == "__main__":
    sys.exit(main())
