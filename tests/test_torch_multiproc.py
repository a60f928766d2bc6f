"""Process-spanning meshes: the port's sharded, overlapped, sharded-hybrid
and batched solves in two processes joined by ``torch.distributed`` over
Gloo on the CPU (``python -m sslap_tpu_torch.parallel.multiproc``), each
equal bit for bit to the one-process run on a CPU mesh of the same shard
count, and to scipy's objective (the sharded and sharded-hybrid solves
also over NCCL, a card a process, where two cards are present); a saved
problem solved under a round cap
(``--problem``) equal to the same solve in one process; the card as the
default device; and ``initialize_multihost``'s no-op and raise.

Each spawn has its own timeout (the launcher's, inside the test's), and
the workers run one torch thread each.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from sslap_tpu_torch import auction as PA
from sslap_tpu_torch import ingest
from sslap_tpu_torch import parallel as PP
from sslap_tpu_torch.batch import auction_solve_batched, stack_problems
from sslap_tpu_torch.parallel import mesh as PM
from sslap_tpu_torch.parallel import multiproc as MP

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _launch(tmp_path, *args, timeout=150):
    out = tmp_path / "worker0.npz"
    run = subprocess.run(
        [sys.executable, "-m", "sslap_tpu_torch.parallel.multiproc",
         "--device", "cpu", "--timeout", str(timeout - 30), "--out",
         str(out), *args],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-2000:]
    line = [ln for ln in run.stdout.splitlines() if ln.startswith("{")][-1]
    return json.loads(line), np.load(out)


@pytest.mark.parametrize("backend,local", [("sharded", 1), ("overlapped", 2)])
def test_two_process_solve_matches_one_process(tmp_path, backend, local):
    """2 processes x ``local`` CPU shards each against one process with a
    CPU mesh of 2 x local: sol, prices bits, rounds, phases, final eps."""
    rep, got = _launch(tmp_path, "--backend", backend, "--n", "256",
                       "--local-devices", str(local))
    assert rep["ok"] and rep["obj"] == rep["scipy_obj"]
    assert rep["nproc"] == 2 and rep["n_shards"] == 2 * local
    loc, val = MP.build_instance(256, 8, 0)
    fn = {"sharded": PP.auction_solve_sharded,
          "overlapped": PP.auction_solve_overlapped}[backend]
    one = fn(loc=loc, val=val, shape=(256, 256),
             mesh=PP.make_mesh([CPU] * (2 * local)))
    np.testing.assert_array_equal(got["sol"], one["sol"])
    assert got["prices"].tobytes() == one["prices"].tobytes()
    assert (int(got["its"]), int(got["phases"]), float(got["final_eps"])) \
        == (one["meta"]["its"], one["meta"]["phases"],
            one["meta"]["final_eps"])
    assert float(got["obj"]) == one["meta"]["obj"] == rep["scipy_obj"]


def test_two_process_sharded_hybrid_matches_one_process(tmp_path):
    """The sharded hybrid in 2 processes x 1 CPU shard (its compact
    rounds all-gather across the processes; each process runs the host GS
    tail) against one process on a CPU mesh of 2: sol, prices bits,
    rounds, phases, final eps, tier_rounds and host bids; and scipy's
    objective."""
    rep, got = _launch(tmp_path, "--backend", "sharded_hybrid", "--n",
                       "256")
    assert rep["ok"] and rep["obj"] == rep["scipy_obj"]
    assert rep["nproc"] == 2 and rep["n_shards"] == 2
    loc, val = MP.build_instance(256, 8, 0)
    one = PP.auction_solve_sharded_hybrid(loc=loc, val=val, shape=(256, 256),
                                          mesh=PP.make_mesh([CPU] * 2))
    mt = one["meta"]
    assert sum(mt["tier_rounds"][2:]) > 0        # compact rounds ran
    np.testing.assert_array_equal(got["sol"], one["sol"])
    assert got["prices"].tobytes() == one["prices"].tobytes()
    assert (int(got["its"]), int(got["phases"]), float(got["final_eps"]),
            list(got["tier_rounds"]), int(got["host_bids"])) == \
        (mt["its"], mt["phases"], mt["final_eps"], mt["tier_rounds"],
         mt["host_bids"])
    assert float(got["obj"]) == mt["obj"] == rep["scipy_obj"]


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["sharded", "sharded_hybrid"])
def test_two_process_nccl_on_two_cards_matches_one_process(tmp_path,
                                                           backend):
    """Two processes over NCCL, a card each (their all-reduces and the
    sharded hybrid's all-gathers stay on the cards; the result is gathered
    from the cards) against one process on a CPU mesh of 2: sol, prices
    bits, rounds, phases, final eps; and scipy's objective."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (NCCL takes a card a process)")
    rep, got = _launch(tmp_path, "--backend", backend, "--n", "256",
                       "--device", "cuda", "--dist-backend", "nccl")
    assert rep["ok"] and rep["obj"] == rep["scipy_obj"]
    assert rep["dist_backend"] == "nccl" and rep["n_shards"] == 2
    loc, val = MP.build_instance(256, 8, 0)
    fn = {"sharded": PP.auction_solve_sharded,
          "sharded_hybrid": PP.auction_solve_sharded_hybrid}[backend]
    one = fn(loc=loc, val=val, shape=(256, 256),
             mesh=PP.make_mesh([CPU] * 2))
    mt = one["meta"]
    np.testing.assert_array_equal(got["sol"], one["sol"])
    assert got["prices"].tobytes() == one["prices"].tobytes()
    assert (int(got["its"]), int(got["phases"]), float(got["final_eps"])) \
        == (mt["its"], mt["phases"], mt["final_eps"])
    if backend == "sharded_hybrid":
        assert sum(mt["tier_rounds"][2:]) > 0    # compact rounds ran
        assert list(got["tier_rounds"]) == mt["tier_rounds"]


def test_two_process_batched_matches_one_process(tmp_path):
    """The batched solve over a 'batch' mesh across two processes (the
    reference's test_two_process_batched_dp): every instance's solution
    and objective equal the one-process run's and scipy's."""
    rep, got = _launch(tmp_path, "--backend", "batched", "--n", "256")
    assert rep["ok"] and rep["objs_match"] == rep["B"] == 4
    inst = MP.batch_instances(256, 8, 0, 4)
    sols, metas = auction_solve_batched(
        stack_problems([p for _, p in inst]), mode="device",
        mesh=PP.make_mesh([CPU] * 2, "batch"))
    np.testing.assert_array_equal(got["sols"], sols)
    assert list(got["its"]) == [mt["its"] for mt in metas]
    assert list(got["objs"]) == [mt["obj"] for mt in metas]


@pytest.mark.parametrize("backend", ["sharded", "overlapped"])
def test_two_process_saved_problem_matches_one_process(tmp_path, backend):
    """``--problem``: a saved int32 ELL problem and eps schedule, solved in
    two processes under a round cap that stops it early, equals the same
    low-level solve on a CPU mesh of 2 (sol, prices bits, rounds, phases,
    unassigned), and the report carries the solve's own time."""
    n, cap = 256, 40
    prob = ingest.from_coo(*MP.build_instance(n, 8, 1), shape=(n, n),
                           pad_to=16)
    vmax = float(np.abs(prob.vals[prob.valid]).max())
    tr = PA.make_transform("min", n, prob.vals.dtype, vmax)
    theta = PA.device_theta_default(n)
    e0, e_min, theta_v = PA.default_eps_schedule(prob.vals.dtype, vmax, n,
                                                 tr.scale, theta=theta)
    tv = prob.vals[prob.valid].astype(np.float64) * (tr.sign * tr.scale)
    bigp, tail = float(tv.max() - tv.min()) + 1.0, 3.0 if theta > 5 else 0.0
    vals_t, p0 = tr.apply(prob.vals), np.zeros(n, prob.vals.dtype)
    path = tmp_path / "problem.npz"
    MP.save_problem(path, prob.cols, vals_t, prob.valid, prob.nvalid, p0,
                    e0, e_min, theta_v, bigp, tail)
    rep, got = _launch(tmp_path, "--backend", backend, "--problem",
                       str(path), "--max-iter", str(cap))
    mesh = PP.make_mesh([CPU] * 2)
    if backend == "overlapped":
        one = PP.solve_ell_overlapped(prob.cols, vals_t, prob.valid,
                                      prob.nvalid, mesh, p0, e0, e_min,
                                      theta_v, cap, bigp, theta_tail=tail)
    else:
        one = PP.sharded_solve_ell(prob, vals_t, mesh, p0, e0, e_min,
                                   theta_v, cap, bigp, n, theta_tail=tail)
    assert one.rounds == cap and one.unassigned > 0    # stopped by the cap
    np.testing.assert_array_equal(got["sol"], one.sigma.numpy())
    assert got["prices"].dtype == np.int32
    assert got["prices"].tobytes() == one.prices.numpy().tobytes()
    assert (int(got["its"]), int(got["phases"]), int(got["unassigned"])) \
        == (one.rounds, one.phases, one.unassigned)
    assert rep["ok"] and rep["n_shards"] == 2 and rep["rounds"] == cap
    assert rep["solve_s"] > 0 and rep["ms_per_round"] == pytest.approx(
        1e3 * rep["solve_s"] / cap)


def test_launcher_defaults_to_the_card_and_checks_problem_args():
    """The workers solve on the card unless the caller names the CPU;
    ``--problem`` wants a round cap and a solve backend; NCCL wants the
    card."""
    assert MP.parse_args([]).device == "cuda"
    assert MP.parse_args(["--device", "cpu"]).device == "cpu"
    for bad in (["--problem", "p.npz"],
                ["--problem", "p.npz", "--max-iter", "5", "--backend",
                 "batched"],
                ["--problem", "p.npz", "--max-iter", "5", "--backend",
                 "sharded_hybrid"],
                ["--backend", "sharded_hybrid", "--instrument"],
                ["--device", "cpu", "--dist-backend", "nccl"]):
        with pytest.raises(SystemExit):
            MP.parse_args(bad)


def test_initialize_multihost_noop_and_one_process_group(monkeypatch):
    """Nothing given and no group in the environment: a no-op.  A group of
    one process: make_mesh stays in this process (and names no CPU by
    itself), a second call is a no-op, ProcessRows gathers this process's
    rows."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    PP.initialize_multihost()
    assert not dist.is_initialized()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    PP.initialize_multihost(f"localhost:{port}", 1, 0, backend="gloo",
                            timeout=30)
    try:
        assert dist.is_initialized() and dist.get_world_size() == 1
        PP.initialize_multihost(f"localhost:{port + 1}", 3, 2)   # no-op
        mesh = PP.make_mesh([CPU] * 2)
        assert mesh.processes == [0, 0] and not mesh.spans_processes
        # no card and no devices named: the group does not make it the CPU
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PP.make_mesh()
        rows = PM.ProcessRows(torch.arange(6).reshape(3, 2))
        np.testing.assert_array_equal(PM.fetch_global(rows),
                                      np.arange(6).reshape(3, 2))
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_initialize_multihost_raises_on_an_explicit_request():
    with pytest.raises(ValueError, match="together"):
        PP.initialize_multihost("localhost:1234")
    with pytest.raises(ValueError, match="not in"):
        PP.initialize_multihost("localhost:1234", 2, 2)
    assert not dist.is_initialized()
    # rank 1 of 2 with nobody at the coordinator's port: the connection
    # fails after the timeout and the error reaches the caller
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = ("from sslap_tpu_torch.parallel import initialize_multihost\n"
            f"initialize_multihost('localhost:{port}', 2, 1, "
            "backend='gloo', timeout=1)\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT, env=env)
    assert run.returncode != 0
    assert "Error" in run.stderr.splitlines()[-1]
