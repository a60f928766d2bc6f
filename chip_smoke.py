"""Drive the PyTorch + CUDA port (``sslap_tpu_torch``) on one GPU.

    python3 chip_smoke.py               # every phase (below)
    python3 chip_smoke.py --k12 LABEL   # K1 and K2's timings alone
    python3 chip_smoke.py --k3 LABEL    # K3's timings on the headline tail
    python3 chip_smoke.py --probes LABEL  # the probe timings alone
    python3 chip_smoke.py --commit-keys LABEL  # the fused commit alone
    python3 chip_smoke.py --sharded-hybrid LABEL  # phase 13 alone
    python3 chip_smoke.py --candidates LABEL  # phase 14 alone
    python3 chip_smoke.py --tracking LABEL    # phase 15 alone

Run from the repository root on a machine with a CUDA device.  Phases, each
of which raises on failure (so the exit code is non-zero):

  1. device   -- a CUDA device must exist; prints its name and power limit
  2. build    -- compiles the hand-written kernels (ops/csrc/*.cu) with nvcc
  3. kernels  -- K1 and K2 against their plain PyTorch twins on the card
                 at their shapes (K = 10, n = m = 1M; C = 256, 3072 and
                 1M), float32 and int32, plus a tie-heavy resolve case.
                 Tolerance: exact (targets, winners, owner and sigma equal;
                 bids and prices bit for bit).  Times from CUDA events,
                 median of reps of one call each (which includes the
                 wrapper's host launch overhead, ~30-40 us), and for the
                 kernels also device time per call of calls queued back
                 to back behind a sleep kernel (CUDA events around them;
                 ms_device).  At C = 1M each kernel's byte bound and the
                 share of it reached, and two limiter readings (back to
                 back): K1 with every column folded into 0..31 (its price
                 gathers then hit L1, not random L2 sectors) and K2 with
                 no bidder (its two launches and the streaming of its
                 id lists).  Then the ladder kernel (ops.ladder_phase,
                 one launch per eps phase) against its plain version (the
                 host loop over K1's and K2's plain versions) on the
                 headline's device pass (the instance of phase 5, built
                 here): the first three phases (max_phases=2) and, when the
                 plain version's estimate is under PLAIN_WHOLE_SECONDS, the
                 whole pass; exact on sigma, owner, prices bits, rounds,
                 phases and tier_rounds
  4. parity   -- the port on CUDA against the port on the CPU at 20k x 20k
                 (identical solution, prices and round counts), and a
                 2k x 2k integer instance against scipy's optimum
  5. headline -- the 1M x 1M, ~10 nnz/row float32 instance (bench.py's
                 generator and seed) through AuctionSolver(mode="hybrid",
                 device="cuda"), cold and then cached, held against the
                 port's own mode="cpu" solve: |obj - obj_cpu| <= n * eps_min.
                 The cold solve must make one ladder launch per phase and
                 no K1/K2 launch; it prints device_time, ms/round, its,
                 tier_rounds, host bids and the ladder's per-round cost
                 above and below its one-block tail (%globaltimer), and a
                 torch.profiler window over one cached device pass prints
                 the device's idle share.  Then the device seed of the HK
                 pre-check on the headline: the greedy maximal matching on
                 the card against the port on the CPU (bit for bit, with
                 its rounds and matched share), is_feasible with
                 device_seed False and True (median of SEED_REPS calls
                 each; equal answers, equal HK sizes), and its split (CSR,
                 column table, HK from each seed)
  6. gs       -- K3 (ops.gs_auction_device) on the headline's tail: the
                 square hybrid's device pass is rebuilt from the package's
                 functions, owner derived, the unassigned rows with entries
                 queued ascending (the native engine's order).  K3 with
                 prefetch on (the look-ahead bid warps beside the commit
                 warp) and off (the commit warp alone), each against its
                 twin for the first 20,000 bids (exact), then each and the
                 native forward auction_gs on that state to the end (or all
                 to one cap, if K3 would need more than 60 s): prices bit
                 for bit, owner and bid counts equal; the kernel's counters
                 (speculative, redone, single-row-ring bids and the ring
                 length histogram) must add up, and the histogram must not
                 depend on prefetch.  Then the reference's _scan stubs
                 ("const", "noprices") on the same state, prefetch on and
                 off: exact against the twin over 20,000 bids, timed over
                 1,000,000 bids (the chain without its K price gathers)
  7. rect     -- the 100k x 200k, 10 nnz/row rectangular sweep row
                 (benchmarks/run_all.py:make_sparse, integer costs < 10,000,
                 seed 11) through mode="hybrid" on the card and mode="cpu".
                 Scaled by m + 1 these costs exceed the exact int32 range,
                 so ingest gives them float64, which only mode="cpu" takes
                 (as in the reference): the device solve runs them as
                 float32 and is held to the eps-optimality bound m *
                 eps_min against the exact mode="cpu" objective (equality
                 is reported), and bit for bit to the same float32 hybrid
                 solve with device="cpu" (K1's and K2's plain versions)
  8. jacobi   -- CUDA against CPU, bit for bit: the rectangular hybrid at
                 10k x 20k (int32), mode="device" at 10k x 10k (float32)
                 and at 10k x 20k (int32, capped at 1,000 rounds: the
                 full-width rectangular solve can spend its whole
                 max_iter, 50 n + 2000 rounds, there)
  9. probes   -- the GS micro-probes (ops.probe_gs, P1-P17 and K3's
                 gs_small*): the suite as `python -m
                 sslap_tpu_torch.ops.probe_gs` runs it, launch counts zeroed
                 around it; each probe's kernel against its plain version
                 at the reference's shapes (exact) with the reference's
                 asserts; every probe kernel's device time per call there
                 (torch.profiler over 20 calls, and 20 calls back to back
                 where the wrapper does not synchronise) beside an empty
                 kernel's (the launch floor) and index_select's on the
                 rows the probe copies; P15 at 2**20 positions over 2**18
                 row pairs (256 MB, made from a seed), and P7, P10 and P11
                 on the same queue and rows (P10's vbm and P11's price and
                 owner tables made on the card from a seed), each against
                 its plain version over 20,000 positions and a numpy form
                 over all, beside its byte bounds; P6 (the pump) at n = 0,
                 1 and 17 against its plain version and the closed form,
                 and P6 and P9 (both on the pump kernel) over 500,000
                 copies from a 512 MB table of distinct rows (entry (r, c)
                 = 131 r + c, made on the card), each checked in closed
                 form, with P6 and index_select of the same rows back to
                 back; the ladder kernels (P16, P17),
                 stages 1-3, at n = m = 1M, K = 10: against the plain
                 version over 20,000 bids and in closed form over all 1M
                 bids, then on the two instances whose first columns
                 repeat (u mod 65,536; three queued rows on one column)
                 against the plain version over 200,000 bids (three at
                 stages 1-2 of the second, which has no more) and timed
                 to 1M bids
 10. batch    -- BASELINE config 3 at full size (benchmarks/run_all.py's
                 instance: 256 x make_sparse(4096, 4096, 48, seed=100 + b),
                 float32, pad_to=52): the dense bid kernel DK
                 (ops.dense_bid) against its plain version on chunk 0 (32
                 instances, C = all 131,072 rows and C = 256 + pads) and
                 K1's batched entry (ops.bid_topk_batched) on the flattened
                 ELL of 32 instances (mode="device"'s pass) and of all 256,
                 and K2 on the first round of mode="device" over the 32,
                 exact, timed as in phase 3 beside their byte bounds (K2
                 also with no bidder); auction_solve_batched with
                 mode="hybrid" (cold; a second call with the default
                 mode 'auto', which must route there; the batch as one
                 chunk), "cpu", and "device" on the first 32 instances,
                 each with inst/s, device_time / host_gs_time, rounds,
                 launches (DK and K2; K1 batched and K2) and the max over
                 instances of |obj - obj_cpu| against n * final_eps (every
                 instance must be found and within it); torch.profiler over
                 one mode="device" call on the 32 (K1, K2, torch ops and
                 idle, per round) and over chunk 0's device pass (DK's
                 share of the device time, the idle share, K2's time and
                 launches); CUDA == CPU bit for bit at
                 B = 4, n = 256 (dense hybrid and batched Jacobi); and
                 AuctionSolver(mode="hybrid") on a dense 4096 x 4096
                 matrix, which takes engine="dense": float32 cold and
                 cached within n * final_eps of scipy's optimum, int32
                 (costs < 1000, ties in every row) reported as it ends
                 (its GS tail budget runs out, as the reference's does on
                 the CPU: dense_tail_budget.py)
 11. sharded  -- the row-sharded Jacobi solve (sslap_tpu_torch.parallel):
                 the 1M headline through sharded_solve_ell on [cuda] and
                 [cuda] * 4 (four shards on the one card), capped at
                 SHARD_ROUNDS rounds, each equal to the port's solve_ell
                 on the card under the same cap (sigma, prices bits,
                 rounds, phases), K1, K2's resolve launch and the fused
                 key commit once a shard a round and K2's commit launch
                 never; ms a round, and a torch.profiler window over
                 SHARD_PROFILE_ROUNDS rounds on four shards (K1, the
                 resolve launch, the fused commit, torch ops, idle);
                 the resolve launch alone on the headline's first round
                 against its plain version (exact), timed as in phase 3
                 beside its byte bound and scatter_reduce_ amax;
                 AuctionSolver(mode="sharded", device="cuda") on a 5k x 5k
                 float32 instance (complete; |obj - obj_cpu| <= n *
                 eps_min against mode="cpu") and a 5k x 10k int32 one
                 (capped at SHARD_RECT_ROUNDS rounds), and the rectangle
                 with partition="nnz" on [cuda] * 2, each bit for bit
                 against the same solve on a CPU mesh of 4 (2 for nnz),
                 which a child process (--sharded-cpu) computes beside
                 these card solves (after the headline's timings);
                 auction_solve_batched(mode="device")
                 over a "batch" mesh of [cuda] * 2 at B = 4, n = 256,
                 equal to the call without a mesh
 12. overlapped -- the overlapped row-sharded solve, the fused key commit
                 (ops.commit.commit_keys), the round breakdown and a
                 process-spanning mesh: the fused commit against its plain
                 version on the 1M headline's first two sharded rounds
                 (float32 and int32 values, unguarded, guarded, and
                 guarded on stale prices; one shard and shard 1 of 4),
                 exact, timed as in phase 3 beside its byte bound;
                 solve_ell_overlapped on the 1M headline on [cuda] and
                 [cuda] * 4 capped at SHARD_ROUNDS, equal bit for bit
                 (sigma, prices, rounds, phases), K1, the resolve launch
                 and the fused commit once a shard a round, ms a round
                 and a profiler window over SHARD_PROFILE_ROUNDS rounds on
                 four shards; measure_round_breakdown on the headline, 1
                 and 4 shards, overlap off and on; AuctionSolver(
                 mode="overlapped", device="cuda") on phase 11's 5k
                 float32 instance, complete (|obj - obj_cpu| <= n *
                 eps_min against mode="cpu"), bit for bit against the
                 same solve on a CPU mesh of 4 (a second child,
                 --overlapped-cpu, started beside phase 11's); and the
                 overlapped solve in two processes on the one card
                 (parallel/multiproc.py over Gloo, a shard each): the 1M
                 headline capped at MP_ROUNDS (multiproc --problem;
                 each round all-reduces the [m] key table, 8 MB), equal
                 bit for bit to the one-process [cuda] * 2 solve run
                 before and after it, its solve time a round against
                 theirs; and AuctionSolver's path end to end at n = MP_N,
                 equal bit for bit to the one-process solve and to
                 scipy's objective.  Phase 12's headline parts run right
                 after phase 11's, before the children start
 13. sharded hybrid -- parallel/sharded_compact.py (HK: phase 5's):
                 (b) auction_solve_sharded_hybrid on the 1M headline
                 (float32, trunc 256) on [cuda] and [cuda] * 4, complete:
                 soln_found, |obj - obj_cpu| <= n * eps_min against phase
                 5's mode="cpu" objective, the two runs equal bit for bit
                 (sol, prices, its, phases, host bids), their device and
                 host GS times, rounds by tier and analytic comm bytes
                 beside the single-card hybrid's phase-5 solve; (a) K2
                 over the four-shard run's first all-gathered set (D * C
                 entries, C the first tier) as shards 0 and 2 committed
                 it, float32 and int32 (rounded), against its plain
                 version, exact, timed as in phase 3 beside its byte bound
                 (ids and bid counted for the bidding entries alone) and
                 scatter_reduce_ amax; (c) overlap=True on [cuda] * 4,
                 its rounds against (b)'s; (d) AuctionSolver(mode=
                 "sharded_hybrid", device="cuda") on phase 11's 5k float32
                 instance, and the solve on [cuda] * 4 at trunc
                 HYBRID_TRUNC, plain and ladder_balance=True
                 (balance_floor 16), and balanced on the reference's
                 contested instance (n = 5000), which must rebuild its
                 buffers at least once, each bit for bit against the same
                 solve on the CPU (a child, --sharded-hybrid-cpu, started
                 at the phase's start); (e) multiproc --backend
                 sharded_hybrid, two processes on the one card over Gloo
                 at n = MP_N, equal bit for bit to the one-process [cuda] *
                 2 solve and to scipy's objective; a torch.profiler
                 window over the four-shard device pass's first
                 HYBRID_PROFILE_ROUNDS rounds (K1, K2, the fused commit,
                 torch ops, idle share).  Every run checks its
                 launches: per shard K1 once a round, K2's resolve launch
                 alone and the fused commit once a full-width round (the
                 fused commit also once a phase for the overlapped
                 regime's drain), K2 once a compact exchange round
 14. candidates -- the candidate-list engine (engine='candidates'),
                 calibrate and utils: (a) the 1M headline through
                 AuctionSolver(mode="hybrid", engine="candidates",
                 device="cuda"), complete: soln_found, |obj - obj_cpu| <=
                 n * eps_min against phase 5's mode="cpu" objective, its
                 device pass (seconds, rounds, phases, rescans, rounds by
                 tier) beside phase 5's compact pass, the host GS tail,
                 and its launches against its rounds (K2 once a round,
                 K1 once a compact-tier round, no ladder); (b) a 20k x
                 20k square instance (phase 4's), float32 and int32,
                 modes "hybrid" and "device" with engine="candidates", each
                 equal to the same solve with device="cpu" (a child,
                 --candidates-cpu, started at the phase's start) bit for
                 bit (sol, prices, its, phases, host bids, tier_rounds,
                 rescans), launches checked; (c) K2 over one joint set of
                 (a) (fast and rescan bids, C + resc_cap entries, from a
                 tier below the top one) against its plain version, exact,
                 timed as in phase 3 beside its byte bound (ids and bid
                 for the bidders alone) and scatter_reduce_ amax; (d) a
                 torch.profiler window over the headline's candidate
                 device pass capped at CAND_PROFILE_ROUNDS rounds: K1, K2,
                 the torch ops and their device time by part of a round
                 (shortlist bid, rescan, compact rounds, the rest) and the
                 idle share; (e)
                 calibrate.measure_host_rate(), measure_gather_ns() and
                 crossover(force=True) with its cache in a temporary
                 directory; (f) utils.profile_trace around a cached 20k
                 candidates solve (the trace holds the annotation and K1's
                 and K2's kernels) and device_alive()
 15. tracking -- the tracking workload and the examples
                 (sslap_tpu_torch.benchmarks.tracking, .examples): (a)
                 families A (value drift, chained warm prices, eps_start =
                 4 sigma), C (sigma 0.5, 4 frames) and B (pattern churn:
                 warm Hopcroft-Karp from the previous matching, then the
                 FR-tightened warm solve) at the 1M headline, TRACK_FRAMES
                 frames, mode="hybrid" on the card, --warm fr,
                 --gs-engine forward: every frame soln_found, each warm
                 frame's objective within n * eps_min of the same frame's
                 cold one, per frame one ladder launch per phase and no
                 other launch; per frame its record, the solve's device /
                 readback / host GS seconds, phases, rounds, tier_rounds,
                 hk_s, fell_back, peak and resident device memory; per
                 family frames/s cold and warm and the peak; (b) the same
                 chains at TRACK_PARITY_N with device="cuda" and "cpu",
                 equal frame for frame (records but timers, sol, prices
                 bits, its, phases, host bids, soln_found, fell_back); (c)
                 the examples: basic on the card == device="cpu";
                 tracking (mode="device", 5 warm-chained frames at
                 EX_TRACK_N) bit for bit against device="cpu" (a child,
                 --tracking-cpu, started at the phase's start, one torch
                 thread), warm rounds below cold on frame 1, one ladder
                 launch per phase; distributed on make_mesh() and on
                 [cuda] * 4 with its asserts (sharded == single, overlap
                 and ladder_balance give the hybrid's objective)

The line before the last is {"kernels": [...]}: per kernel, the launches
counted on its path (the ladder: the cold headline solve; K1, K2: the
rectangular hybrid of phase 7, their path since the square hybrid runs the
ladder, with batched_launches beside from phase 10: K1's batched entry in
mode="device", K2 in both batched modes; DK: the cold config-3 hybrid
solve; K3: the two tail runs; P1-P17: the probe suite), its time and its
plain version's time (K1, K2: C = 1M, float32, with ms_device beside;
the ladder: the pass of phase 3; K3: one call over the first 20,000 bids
of the tail, with ms_noprefetch beside, whole_tail_us_per_bid (prefetch on
and off, and the native forward GS, over the whole tail), bid_warps and
the counters;
P1-P17: the reference shapes, P16/P17 at stage 3, with ns/iteration or
ns/bid of the scaled runs beside; P6's rows_500k: its time at scale
against its byte bound and index_select's; P16/P17's ms_device back to
back, ns/bid on the conflict instances, the byte and float-chain bounds
at 1M (two dependent adds a bid, 4 cycles each at the card's maximum SM
clock) and the share of each reached, and their counters; every probe's
kernel_us, its kernel's device time per call from the profiler, and
library_kernel_us, index_select's on the rows it copies; P7, P10, P11 and
P15's scale_2e20, P15's launch_floor_us), its bound (bound_ms, bound_by,
bound_bytes: each input read once and each output written once on that
run's data, over 3.35 TB/s, or its operations over 67 TFLOP/s) and the
time of one PyTorch call computing the same function where there is one
(library_ms: scatter_reduce_ amax for K2's resolve, index_select for the
row copies of P1-P3 and P6-P15 (P10: of both tables), whose entries also
carry library_ms_device, the device time per call of 20 calls back to
back, and (P1-P6, P9, whose wrappers do not synchronise) ms_device; else
null).  DK's entry is at C = 131,072
(the first round of a chunk), with its C = 256 numbers beside; K1's
carries its batched entry's numbers as batched_* (a chunk of 32 instances,
131,072 rows, as mode="device" runs it; all 256 instances as
batched_all_*), K2's its first round on that chunk as batched_*, both their
device time in one mode="device" call as batched_device_mode_ms, and the
limiter readings as ms_local_gathers (K1 at 1M) / ms_no_bidder.  K1's and
K2's entries also carry sharded_launches, their launches on phase 11's
sharded runs (K2: the resolve launch alone), K1's the profiler split
(sharded_profile) and K2's the resolve launch's own numbers
(sharded_resolve: ms, ms_device, plain_ms, bound, library_ms), and their
launches on phase 12's overlapped runs (overlapped_launches).  The fused
key commit's entry (commit_keys) counts its launches on phase 12's 1M
overlapped runs, with phase 11's sharded ones beside, and carries the
overlapped profiler split, round times, breakdowns and the two-process
run.  Phase 13 adds sharded_hybrid_launches to K1's entry (per run of
(b)-(e); (e): worker 0's process), to K2's (its commit and its resolve
launch alone, per run) with gathered_* beside ((a): ms, ms_device,
plain_ms, bound, library_ms), and to the fused commit's (on (b)), with
the headline's sharded hybrid summary (sharded_hybrid).  Phase 14 adds
candidates_launches to K1's and K2's entries (per run: (a)'s headline,
(b)'s four card runs) and, to K2's, candidates_joint_* ((c): the tier,
entries, bids, ms, ms_device, plain_ms, bound, library_ms).  Phase 15
adds tracking_launches to the ladder's entry ((a): per family and frame
kind), with tracking_parity_launches ((b)'s card run) and
tracking_example_launches, and distributed_example_launches to K1's, K2's
(commit and resolve) and the fused commit's (per mesh of (c)).  The
profiler windows count device-side events only (a CPU op's device time
repeats its kernels').  The last line is {"ok": true, "device": {...}}.
Imports nothing of JAX.

--tracking LABEL runs only phase 15 and prints its numbers as one line
"TRACKING LABEL {...}"; --tracking-cpu PATH is its child (the tracking
example with device="cpu", saved to PATH).

--candidates LABEL runs only phase 14 (after the single-card hybrid's
cached solve and the mode="cpu" objective of phase 5) and prints its
numbers as one line "CANDIDATES LABEL {...}".

--k12 LABEL runs only the K1 and K2 measurements: phase 3's at C = 1M
(float32; times, bounds, limiters, scatter_reduce_), phase 10's on config 3
(K1's batched entry on the chunk of 32 and on all 256, K2 on the chunk's
first round, the profiler over chunk 0's dense pass) and one mode="device"
solve of the chunk (wall time, rounds, objectives, then its profiler
split), each kernel checked against its plain version on the way, and
prints them as one line "K12 LABEL {...}" (no contract line).  The script
imports sslap_tpu_torch from its own directory, so a copy of it placed at
the root of another tree of this repository (an older commit unpacked with
git archive) measures that tree's kernels with this code: run the two
trees in turns (A, B, B, A) in one process sequence on one card.

--probes LABEL runs only phase 9's timings (P6 back to back at the
reference shape, with index_select beside it, and both P6's and
index_select's kernels' device time per call under torch.profiler; the
launch floor and every probe kernel's device time per call at the
reference shape, beside index_select's; P15, P7, P10 and P11 at scale; P6
at n = 0, 1, 17 and P6/P9 at 500,000 copies; the ladder kernels at 1M
rows, closed form and conflict instances) and prints them as one line
"PROBES LABEL {...}"; A/B between trees as --k12 (a tree whose
ladder_inputs has no first= skips the conflict instances).

--sharded-cpu PATH is phase 11's child: its solves on CPU meshes, saved to
PATH (npz); --overlapped-cpu PATH is phase 12's, --sharded-hybrid-cpu
PATH phase 13's, --candidates-cpu PATH phase 14's.

--sharded-hybrid LABEL runs only phase 13 (after the single-card hybrid's
cold and cached solves and the mode="cpu" objective of phase 5) and prints
its numbers as one line "SHARDED_HYBRID LABEL {...}".

--commit-keys LABEL runs only phase 12's fused commit check and timings
on the headline's first two sharded rounds and prints them as one line
"COMMIT_KEYS LABEL {...}"; A/B between trees as --k12.

--k3 LABEL runs only phase 6's K3 measurements (no _scan stubs), plus the
whole tail at each number of bid warps in K3_SWEEP (through the module
constant ops.gs_kernel.BID_WARPS), and prints them as one line "K3 LABEL
{...}"; a copy of the script at the root of
another tree measures that tree's K3 the same way (counters are null for a
K3 that keeps none).
"""

from __future__ import annotations

import contextlib
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from sslap_tpu_torch import AuctionSolver, ELLProblem, _native, from_coo
from sslap_tpu_torch import auction as A
from sslap_tpu_torch import batch as BT
from sslap_tpu_torch import candidate as CD
from sslap_tpu_torch import compact as C
from sslap_tpu_torch import dense_batch as DB
from sslap_tpu_torch import feasibility as F
from sslap_tpu_torch import feasibility_device as FD
from sslap_tpu_torch import hybrid as H
from sslap_tpu_torch import parallel as PP
from sslap_tpu_torch.auction import neg_sentinel_np
from sslap_tpu_torch.batch import auction_solve_batched, stack_problems
from sslap_tpu_torch.benchmarks import tracking as TR
# bench.make_instance's copy (bench.py imports jax); time_headline.py
# imports it from here
from sslap_tpu_torch.benchmarks.tracking import make_instance
from sslap_tpu_torch.examples import basic as EXB
from sslap_tpu_torch.examples import distributed as EXD
from sslap_tpu_torch.examples import tracking as EXT
from sslap_tpu_torch.ops import _build, bid_topk, bid_topk_batched, \
    bid_topk_batched_plain, bid_topk_plain, commit, commit_plain, dense_bid, \
    dense_bid_plain, gs_auction_device, gs_auction_plain, ladder_phase, \
    ladder_phase_plain
from sslap_tpu_torch.ops import gs_kernel as GK
from sslap_tpu_torch.ops.commit import commit_keys, commit_keys_plain, \
    resolve
from sslap_tpu_torch.parallel import multiproc as MP
from sslap_tpu_torch.ops import ladder as L
from sslap_tpu_torch.ops import probe_gs as PG

N_HEAD = 1_000_000
K_HEAD = 10
NNZ_HEAD = 9_999_949          # bench.make_instance(1M, 1M, 9, seed=0)
DEVICE = "cuda"

KERNELS = {
    "bid_topk": {"route": "cuda",
                 "source": "sslap_tpu_torch/ops/csrc/bid.cu",
                 "replaces": "sslap_tpu/ops/bid.py:59"},
    "commit": {"route": "cuda",
               "source": "sslap_tpu_torch/ops/csrc/commit.cu",
               "replaces": "sslap_tpu/ops/commit.py:26"},
    "gs_auction_device": {"route": "cuda",
                          "source": "sslap_tpu_torch/ops/csrc/gs.cu",
                          "replaces": "sslap_tpu/ops/gs_kernel.py:64"},
    "ladder": {"route": "cuda",
               "source": "sslap_tpu_torch/ops/csrc/ladder.cu",
               "replaces": "sslap_tpu/ops/bid.py:59 + "
                           "sslap_tpu/ops/commit.py:26"},
    # no TPU kernel behind the fused key commit either: it replaces the
    # XLA jnp commit of the sharded and overlapped rounds
    "commit_keys": {"route": "cuda",
                    "source": "sslap_tpu_torch/ops/csrc/commit.cu",
                    "replaces": "sslap_tpu/parallel/overlap.py:95 + "
                                "sslap_tpu/auction.py:162 (XLA, no TPU "
                                "kernel)"},
    # no TPU kernel behind DK: it replaces the XLA-compiled dense bid
    "dense_bid": {"route": "cuda",
                  "source": "sslap_tpu_torch/ops/csrc/dense_bid.cu",
                  "replaces": "sslap_tpu/dense_batch.py:56 (XLA, no TPU "
                              "kernel)"},
}
# The card's published peaks (NVIDIA's H100 SXM data sheet, at 700 W):
# device memory rate and float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
PLAIN_WHOLE_SECONDS = 30.0    # the ladder's plain version runs the whole
                              # headline pass when estimated below this
GS_TWIN_BIDS = 20_000         # K3 against its twin over this prefix
GS_STUB_BIDS = 1_000_000      # the _scan stubs' timed runs on the tail
GS_MAX_SECONDS = 60.0         # above this, K3 and native stop at one cap
K3_SWEEP = (0, 1, 2, 4, 16)   # --k3: the tail at these bid warps too
SEED_REPS = 3                 # phase 5: is_feasible timed this many times
SHARD_ROUNDS = 2000           # phase 11: the 1M sharded solve's round cap
SHARD_PROFILE_ROUNDS = 100    # phase 11: rounds under the profiler
SHARD_N = 5000                # phase 11: the complete sharded solve
SHARD_RECT = (5000, 10000)    # phase 11: rectangular int32, capped at
SHARD_RECT_ROUNDS = 1000      # this many rounds (the full-width
                              # rectangular solve can spend its max_iter)


def log(*args) -> None:
    print(*args, flush=True)


def make_sparse(n, m, nnz_per_row, seed=0, high=1000, integer=True):
    """Copy of benchmarks/run_all.py:make_sparse (benchmarks/ imports jax):
    nnz_per_row - 1 random columns per row plus a planted matching,
    deduplicated by the sorted fused key; integer costs in [1, high), or
    float32 in [1, high)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), nnz_per_row - 1)
    cols = rng.integers(0, m, rows.shape[0], dtype=np.int64)
    perm = rng.permutation(m)[:n].astype(np.int64)
    key = np.concatenate([rows * m + cols,
                          np.arange(n, dtype=np.int64) * m + perm])
    key.sort()
    keep = np.empty(key.shape[0], bool)
    keep[0] = True
    np.not_equal(key[1:], key[:-1], out=keep[1:])
    key = key[keep]
    loc = np.stack([key // m, key % m], 1)
    if integer:
        return loc, rng.integers(1, high, loc.shape[0])
    return loc, (rng.random(loc.shape[0]) * (high - 1) + 1).astype(np.float32)


# ---------------------------------------------------------------------------
# Phases 1-2
# ---------------------------------------------------------------------------


def phase_device() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    log(smi.stdout.strip())
    log(f"[1 device] {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load()
    log(f"[2 build] kernels loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc: {_build.build_seconds} s)")
    for line in (_build.build_log or "").splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("  ptxas:", line.strip())


# ---------------------------------------------------------------------------
# Phase 3: kernels against their twins
# ---------------------------------------------------------------------------


def _inputs(rng, n, m, K, dtype, dev):
    """Random solver state at the main path's widths: per row K distinct
    sorted columns of which the first nvalid are real (0 and 1 included),
    padding col 0 / value = neg sentinel; a random partial matching over
    real entries; random prices."""
    start = rng.integers(0, m, n)
    step = rng.integers(1, m // K, n)
    cols = np.sort((start[:, None] + np.arange(K)[None, :] * step[:, None])
                   % m, axis=1)
    nvalid = rng.integers(0, K + 1, n).astype(np.int32)
    valid = np.arange(K)[None, :] < nvalid[:, None]
    cols = np.where(valid, cols, 0).astype(np.int32)
    if dtype == np.float32:
        vals = -(rng.random((n, K)) * 999 + 1).astype(np.float32)
        prices = (rng.random(m) * 500).astype(np.float32)
        eps, bigp = np.float32(0.37), np.float32(1000.0)
    else:   # int32, scaled by (m + 1) as the exact integer path is
        vals = -(rng.integers(1, 60, (n, K)) * (m + 1)).astype(np.int32)
        prices = rng.integers(0, 30 * (m + 1), m).astype(np.int32)
        eps, bigp = np.int32(1001), np.int32(60 * (m + 1) + 1)
    vals_m = np.where(valid, vals, neg_sentinel_np(dtype))
    # partial matching: each biddable row proposes its first column, the
    # lowest proposer per column keeps it, then half are dropped
    rows = np.flatnonzero(nvalid > 0)
    _, first = np.unique(cols[rows, 0], return_index=True)
    keep = rows[first]
    keep = keep[rng.random(keep.shape[0]) < 0.5]
    sigma = np.full(n, -1, np.int32)
    owner = np.full(m, -1, np.int32)
    sigma[keep] = cols[keep, 0]
    owner[cols[keep, 0]] = keep
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    return dict(cols=t(cols), vals_m=t(vals_m), nvalid=t(nvalid),
                prices=t(prices), sigma=t(sigma), owner=t(owner),
                eps=eps, bigp=bigp, n=n, m=m)


def _ids(rng, st, C, dev):
    """The compacted id list of a round at capacity C (pad = n): at C = n
    the phase-start list, else a sorted sample of unassigned biddable
    rows filling ~80% of C."""
    n = st["n"]
    sigma = st["sigma"].cpu().numpy()
    nvalid = st["nvalid"].cpu().numpy()
    if C == n:
        live = np.flatnonzero(((sigma < 0) & (nvalid > 0)) | (sigma >= 0))
    else:
        pool = np.flatnonzero((sigma < 0) & (nvalid > 0))
        live = np.sort(rng.choice(pool, int(0.8 * C), replace=False))
    ids = np.full(C, n, np.int32)
    ids[:live.shape[0]] = live
    return torch.from_numpy(ids).to(dev)


def _same_bits(a, b) -> bool:
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def _bound(nbytes, nops=0) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=int(nbytes))


def _median_ms(prepare, run, reps: int) -> float:
    """Median device time of run(*prepare()) over reps, CUDA events around
    the call only (inputs are prepared outside the timed window)."""
    for _ in range(2):
        run(*prepare())
    marks = []
    for _ in range(reps):
        args = prepare()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        run(*args)
        t1.record()
        marks.append((t0, t1))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in marks]))


def _device_ms(prepare, run, reps: int) -> float:
    """Device time of run(*prepare()) per call: reps calls (inputs prepared
    first) queued back to back behind a sleep kernel, CUDA events around
    them.  CUDA events around one call of a kernel of tens of us also
    catch the host's launch overhead (the Python wrapper's checks and
    ctypes call take ~30-40 us): the GPU idles between the first event and
    the launch.  run must not synchronise.  Raises if the queue ran dry."""
    run(*prepare())
    cycles = 50_000_000
    for _ in range(4):
        args = [prepare() for _ in range(reps)]
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for a in args:
            run(*a)
        t1.record()
        # the sleep ended before the last call was queued: the GPU may
        # have waited for the host
        dry = t0.query()
        torch.cuda.synchronize()
        if not dry:
            return t0.elapsed_time(t1) / reps
        cycles *= 4
    raise RuntimeError("the launch queue ran dry behind the sleep kernel")


def _check_pair(st, ids, phase_start, reps, keys):
    """K1 then K2 on one round's inputs, kernel vs twin; returns
    (errors, times) dicts keyed by kernel name."""
    mut = ("prices", "sigma", "owner")

    def fresh():
        return [st[k].clone() for k in mut]

    def k1(fn, prices, sigma, owner):
        return fn(ids, st["cols"], st["vals_m"], st["nvalid"], prices,
                  sigma, owner, st["eps"], st["bigp"],
                  phase_start=phase_start)

    got, want = fresh(), fresh()
    tk, bk = k1(bid_topk, *got)
    tt, bt = k1(bid_topk_plain, *want)
    torch.cuda.synchronize()
    if not (torch.equal(tk, tt) and _same_bits(bk, bt)
            and all(torch.equal(a, b) for a, b in zip(got, want))):
        raise AssertionError("bid_topk kernel differs from its twin")
    errs = {"bid_topk": _abs_err(bk, bt)}

    def k2(fn, prices, sigma, owner, **kw):
        return fn(ids, tk, bk, prices, owner, sigma, **kw)

    after1 = got
    got, want = [a.clone() for a in after1], [a.clone() for a in after1]
    out_k = k2(commit, *got, keys=keys)
    out_t = k2(commit_plain, *want)
    torch.cuda.synchronize()
    if not (all(torch.equal(a, b) for a, b in zip(out_k, out_t))
            and _same_bits(got[0], want[0])
            and torch.equal(got[1], want[1])
            and torch.equal(got[2], want[2])
            and int(keys.count_nonzero()) == 0):
        raise AssertionError("commit kernel differs from its twin")
    errs["commit"] = _abs_err(got[0], want[0])

    # single timed calls (the time kept since PR 1, the wrapper's launch
    # overhead included), the kernels' back-to-back device time beside
    def run1(fn):
        return lambda p, s, o: k1(fn, p, s, o)

    def fresh2():
        return [a.clone() for a in after1]

    def run2(**kw):
        return lambda p, s, o: k2(commit if kw else commit_plain, p, s, o,
                                  **kw)
    times = {"bid_topk": _median_ms(fresh, run1(bid_topk), reps),
             "bid_topk_device": _device_ms(fresh, run1(bid_topk), reps),
             "bid_topk_plain": _median_ms(fresh, run1(bid_topk_plain), reps),
             "commit": _median_ms(fresh2, run2(keys=keys), reps),
             "commit_device": _device_ms(fresh2, run2(keys=keys), reps),
             "commit_plain": _median_ms(fresh2, run2(), reps)}
    return errs, times, int(out_k[2][0]), int((tk < st["m"]).sum())


def _check_ties(rng, st, dtype, keys, dev):
    """Resolve with many equal bids, +-0.0 and negative bids, onto a few
    columns some of which are owned: kernel vs twin, exact."""
    n, m = st["n"], st["m"]
    sigma = st["sigma"].cpu().numpy()
    pool = np.flatnonzero(sigma < 0)
    ids = np.sort(rng.choice(pool, 3072, replace=False)).astype(np.int32)
    owned = np.flatnonzero(st["owner"].cpu().numpy() >= 0)[:48]
    cols = np.concatenate([owned, rng.choice(m, 49, replace=False)])
    tgt = rng.choice(cols, ids.shape[0]).astype(np.int32)
    tgt[rng.random(ids.shape[0]) < 0.1] = m                   # no bid
    if dtype == np.float32:
        choices = np.array([-1.5, -0.0, 0.0, 2.0, 7.25], np.float32)
    else:
        choices = np.array([-3, 0, 5], np.int32)
    bid = rng.choice(choices, ids.shape[0])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    ids, tgt, bid = t(ids), t(tgt), t(bid)
    got = [st[k].clone() for k in ("prices", "owner", "sigma")]
    want = [a.clone() for a in got]
    out_k = commit(ids, tgt, bid, *got, keys=keys)
    out_t = commit_plain(ids, tgt, bid, *want)
    torch.cuda.synchronize()
    if not (all(torch.equal(a, b) for a, b in zip(out_k, out_t))
            and _same_bits(got[0], want[0])
            and torch.equal(got[1], want[1])
            and torch.equal(got[2], want[2])):
        raise AssertionError("commit kernel differs from its twin on ties")
    return int(out_k[2][0])


def _k2_bound(ids, tgt, bid, prices, owner, sigma, reps, **kw):
    """K2's bound on one round's bids (each input read once: tgt for
    every entry, ids and bid for the entries that bid (tgt < m: the
    kernel reads no other's) and, per distinct column bid on, its key,
    price and owner; each output written once: stay and evicted for every
    entry, the changed table entries, counts), and
    the one PyTorch call that computes K2's resolve, scatter_reduce_ amax
    on the 64-bit (bid, ~row) keys, timed.  ``kw``: the gathered commit's
    row_offset and n_rows."""
    m = prices.shape[0]
    C = ids.shape[0]
    p2, o2, s2 = prices.clone(), owner.clone(), sigma.clone()
    commit_plain(ids, tgt, bid, p2, o2, s2, **kw)
    bidding = tgt < m
    bids = int(bidding.sum())
    U = torch.unique(tgt[bidding]).numel()
    changed = int((p2.view(torch.int32) != prices.view(torch.int32)).sum()
                  + (o2 != owner).sum() + (s2 != sigma).sum())
    bound = _bound(12 * C + 8 * bids + 20 * U + 4 * changed + 12, bids)
    # (order bits - 2^31) * 2^32 + (2^32 - 1 - row): signed int64 order ==
    # the kernel's unsigned key order
    b = torch.where(bid == 0, torch.zeros_like(bid), bid)
    u = b.view(torch.int32).long() & 0xFFFFFFFF
    hi = torch.where(u >= 2 ** 31, 0xFFFFFFFF - u, u + 2 ** 31)
    key = (hi - 2 ** 31) * 2 ** 32 + (0xFFFFFFFF - ids.long())
    best = torch.zeros(m + 1, dtype=torch.int64, device=ids.device)
    idx = tgt.long()
    lib_ms = _median_ms(lambda: (), lambda: best.scatter_reduce_(
        0, idx, key, "amax"), reps)
    return bound, lib_ms


def _k12_bounds(st, ids, reps):
    """Bounds of K1 and K2 on one phase-start round's inputs (K1: each
    input read once, the live rows and the distinct columns they touch;
    each output written once, tgt, bid and the violators' entries; K2 as
    _k2_bound), and K2's library time (K1 has none)."""
    n, K = st["n"], st["cols"].shape[1]
    C = ids.shape[0]
    p, s, o = (st[k].clone() for k in ("prices", "sigma", "owner"))
    tgt, bid = bid_topk_plain(ids, st["cols"], st["vals_m"], st["nvalid"],
                              p, s, o, st["eps"], st["bigp"],
                              phase_start=True)
    rows = ids[ids < n].long()
    ucols = torch.unique(st["cols"][rows]).numel()
    viol = int((s != st["sigma"]).sum()) + int((o != st["owner"]).sum())
    k1 = _bound(4 * C + rows.numel() * (8 * K + 8) + 4 * ucols + 8 * C
                + 4 * viol, 3 * rows.numel() * K)
    k2, lib_ms = _k2_bound(ids, tgt, bid, p, o, s, reps)
    return k1, k2, lib_ms


def _limiters(st, ids, reps, keys):
    """What holds K1 and K2 back, read from their times on altered inputs
    of the same shape: K1 with every column folded into 0..31 (the K price
    gathers of a row then hit a few L1-resident lines instead of random
    32-byte L2 sectors), and K2 with no bidder (tgt = m: its two launches
    and the streaming of tgt, stay and evicted, no atomic and no table
    access).  Device time of calls queued back to back."""
    cols_local = st["cols"] % 32
    fresh = lambda: [st[k].clone() for k in ("prices", "sigma", "owner")]  # noqa
    k1_local = _device_ms(fresh, lambda p, s, o: bid_topk(
        ids, cols_local, st["vals_m"], st["nvalid"], p, s, o, st["eps"],
        st["bigp"], phase_start=True), reps)
    none = torch.full_like(ids, st["m"])
    zero = torch.zeros(ids.shape[0], dtype=st["prices"].dtype,
                       device=ids.device)
    k2_empty = _device_ms(fresh, lambda p, s, o: commit(
        ids, none, zero, p, o, s, keys=keys), reps)
    return {"bid_topk": {"ms_local_gathers": k1_local},
            "commit": {"ms_no_bidder": k2_empty}}


def phase_kernels(n=N_HEAD, K=K_HEAD, capacities=(256, 3072, N_HEAD),
                  seed=0):
    """K1 and K2 against their twins on the card; returns (max abs error
    per kernel, times at C = n float32 with their bounds and library
    times)."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed)
    errs = {"bid_topk": 0.0, "commit": 0.0}
    headline = {}
    keys = torch.zeros(n, dtype=torch.int64, device=dev)
    for dtype in (np.float32, np.int32):
        st = _inputs(rng, n, n, K, dtype, dev)
        for C in capacities:
            ids = _ids(rng, st, C, dev)
            reps = 20 if C >= 100_000 else 200
            e, t, won, bids = _check_pair(st, ids, C == n, reps, keys)
            for k, v in e.items():
                errs[k] = max(errs[k], v)
            log(f"[3 kernels] {np.dtype(dtype).name} C={C} "
                f"phase_start={C == n}: {bids} bids, {won} won; "
                f"bid_topk {t['bid_topk']:.4f} ms (back to back "
                f"{t['bid_topk_device']:.4f}, twin {t['bid_topk_plain']:.4f}"
                f" ms), commit {t['commit']:.4f} ms (back to back "
                f"{t['commit_device']:.4f}, twin {t['commit_plain']:.4f} "
                f"ms); exact")
            if C == n and dtype == np.float32:
                headline = t
                k1, k2, lib_ms = _k12_bounds(st, ids, reps)
                headline["bounds"] = {"bid_topk": k1, "commit": k2}
                headline["library"] = {"bid_topk": None, "commit": lib_ms}
                headline["limiters"] = _limiters(st, ids, reps, keys)
                log(f"[3 kernels] bound at C={C}: bid_topk {k1} = "
                    f"{k1['bound_ms'] / t['bid_topk']:.1%} of it reached "
                    f"({k1['bound_ms'] / t['bid_topk_device']:.1%} back to "
                    f"back), commit {k2} = "
                    f"{k2['bound_ms'] / t['commit']:.1%} ("
                    f"{k2['bound_ms'] / t['commit_device']:.1%}); "
                    f"scatter_reduce_ amax (K2's resolve) {lib_ms:.4f} ms; "
                    f"limiters (ms): {headline['limiters']}")
        won = _check_ties(rng, st, dtype, keys, dev)
        log(f"[3 kernels] {np.dtype(dtype).name} ties/+-0/negative bids "
            f"C=3072: {won} won; exact")
    return errs, headline


# ---------------------------------------------------------------------------
# Phases 4-5: the solver
# ---------------------------------------------------------------------------


def _solve(loc, val, n, device, **kw):
    return AuctionSolver(loc=loc, val=val, shape=(n, n), mode="hybrid",
                         device=device, **kw).solve()


def phase_parity(n=20_000) -> None:
    rr, cc, vv = make_instance(n, n, 9, seed=1)
    loc = np.stack([rr, cc], 1)
    cases = (("float32", vv, {}),
             ("float32 wide_rounds theta=10", vv,
              dict(wide_rounds=True, theta=10.0)),
             ("int32", np.round(vv).astype(np.int64), {}))
    for name, val, kw in cases:
        g = _solve(loc, val, n, DEVICE, **kw)
        c = _solve(loc, val, n, "cpu", **kw)
        gm, cm = g["meta"], c["meta"]
        if not (np.array_equal(g["sol"], c["sol"])
                and np.array_equal(g["prices"].view(np.int32),
                                   c["prices"].view(np.int32))
                and all(gm[k] == cm[k] for k in ("its", "phases",
                                                 "host_bids",
                                                 "tier_rounds"))
                and gm["soln_found"]):
            raise AssertionError(f"port on CUDA != port on CPU ({name})")
        log(f"[4 parity] {n}x{n} {name}: CUDA == CPU (sol, prices bitwise, "
            f"its {gm['its']}, phases {gm['phases']}, host_bids "
            f"{gm['host_bids']}, tier_rounds[0] {gm['tier_rounds'][0]})")
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import min_weight_full_bipartite_matching
    n2 = 2000
    rr, cc, vv = make_instance(n2, n2, 9, seed=2)
    vi = np.round(vv).astype(np.int64)
    res = _solve(np.stack([rr, cc], 1), vi, n2, DEVICE)
    sp = csr_matrix((vi.astype(np.float64), (rr, cc)), shape=(n2, n2))
    r, c = min_weight_full_bipartite_matching(sp)
    want = int(round(float(sp[r, c].sum())))
    if res["meta"]["obj"] != want:
        raise AssertionError(f"{n2}x{n2} int objective {res['meta']['obj']} "
                             f"!= scipy {want}")
    log(f"[4 parity] {n2}x{n2} int32 on CUDA: objective {want} == scipy")


def headline_solver(n=N_HEAD):
    """The headline instance and its AuctionSolver (ingest done, nothing
    solved)."""
    t0 = time.perf_counter()
    rr, cc, vv = make_instance(n, n, 9, seed=0)
    nnz = rr.shape[0]
    if n == N_HEAD and nnz != NNZ_HEAD:
        raise AssertionError(f"instance nnz {nnz} != {NNZ_HEAD}")
    loc = np.stack([rr, cc], 1)
    solver = AuctionSolver(loc=loc, val=vv, shape=(n, n), mode="hybrid",
                           device=DEVICE)
    log(f"[3 ladder] headline {n}x{n}, nnz {nnz}: instance + ingest "
        f"{time.perf_counter() - t0:.2f} s")
    return solver, loc, vv


def headline_inputs(solver):
    """The square hybrid's device-pass inputs on the headline, built as
    hybrid.solve_hybrid builds them (transform, eps schedule, CSR bigp,
    trunc, fine ladder, wide-loop guard), on the card, outside the
    solver's device cache."""
    prob = solver.problem_spec
    n, m = prob.n, prob.m
    dtype = prob.vals.dtype
    vmax_abs = float(np.abs(prob.vals[prob.valid]).max())
    tr = A.make_transform("min", m, dtype, vmax_abs)
    e0, e_min, theta = A.default_eps_schedule(
        dtype, vmax_abs, m, tr.scale, theta=A.device_theta_default(n))
    csr = H.ell_to_csr_transformed(prob, tr.sign, tr.scale)
    bigp = (csr[2].max() - csr[2].min()) + 1.0
    trunc = min(256, max(n // 8, 1))
    _, ell = H._device_ell(prob, tr, torch.device(DEVICE), None)
    return dict(ell=ell, csr=csr, n=n, m=m, K=prob.cols.shape[1], e0=e0,
                e_min=e_min, theta=theta, bigp=bigp, trunc=trunc,
                tiers=C.default_tiers(n, fine=True, floor=trunc),
                wide=n >= 400_000 and H._wide_layout_ok(prob.cols,
                                                       prob.valid, m))


def headline_device_pass(inp, **kw):
    """compact.solve_tiered as the square hybrid calls it on the headline
    (same schedule, ladder, trunc, mixed tail, wide loop): the state the
    host finisher starts from.  Returns (SolveResult, TieredState)."""
    cols_d, vals_d, nvalid_d = inp["ell"]
    return C.solve_tiered(
        cols_d, vals_d, nvalid_d, torch.zeros(inp["m"], device=cols_d.device),
        inp["e0"], inp["e_min"], inp["theta"], A.default_max_iter(inp["n"]),
        bigp=inp["bigp"], tiers=inp["tiers"], trunc=inp["trunc"],
        theta_tail=np.float32(3.0), tail_phases=2, wide=inp["wide"], **kw)


@contextlib.contextmanager
def _plain_ladder():
    """The tiered solve with its phase op swapped for the op's plain
    version (the host loop over K1's and K2's plain versions and a torch
    sort), on the same CUDA tensors."""
    C.ladder_phase = ladder_phase_plain
    try:
        yield
    finally:
        C.ladder_phase = ladder_phase


def _same_pass(a, b) -> bool:
    (ra, sa), (rb, sb) = a, b
    return (torch.equal(ra.sigma, rb.sigma) and _same_bits(ra.prices,
                                                          rb.prices)
            and torch.equal(sa.owner, sb.owner) and ra.rounds == rb.rounds
            and ra.phases == rb.phases and sa.tier_rounds == sb.tier_rounds
            and ra.unassigned == rb.unassigned)


def phase_ladder(inp):
    """The ladder kernel (ops.ladder_phase) against its plain version on
    the card, on the headline's device pass: three phases (the first, then
    max_phases=2), exact on sigma, owner, prices bits, rounds, phases and
    tier_rounds; and, when the plain version's estimate for the whole pass
    is under PLAIN_WHOLE_SECONDS, the whole pass (the plain version
    resumed from its three-phase state).  Returns the kernels-line entry
    numbers."""
    def run(plain, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _plain_ladder() if plain else contextlib.nullcontext():
            out = headline_device_pass(inp, **kw)
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    whole_k, whole_k_ms = run(False)
    part_k, k_ms = run(False, max_phases=2)
    part_p, p_ms = run(True, max_phases=2)
    if not _same_pass(part_k, part_p):
        raise AssertionError("ladder kernel != its plain version over the "
                             "headline's first three phases")
    err = _abs_err(part_k[0].prices, part_p[0].prices)
    rounds = part_k[0].rounds
    log(f"[3 ladder] headline, phases 1-3 (max_phases=2): kernel "
        f"{k_ms:.1f} ms, plain {p_ms:.1f} ms over {rounds} rounds "
        f"({p_ms / rounds:.3f} ms/round); tier_rounds "
        f"{part_k[1].tier_rounds}; exact (sigma, owner, prices bits, "
        f"rounds, tier_rounds)")
    est_s = 1e-3 * p_ms * whole_k[0].rounds / rounds
    whole = est_s < PLAIN_WHOLE_SECONDS
    if whole:
        rest_p, rest_ms = run(True, init_state=part_p[1])
        if not _same_pass(whole_k, rest_p):
            raise AssertionError("ladder kernel != its plain version over "
                                 "the headline's whole device pass")
        err = max(err, _abs_err(whole_k[0].prices, rest_p[0].prices))
        k_ms, p_ms = whole_k_ms, p_ms + rest_ms
        log(f"[3 ladder] headline, whole pass ({whole_k[0].phases} phases, "
            f"{whole_k[0].rounds} rounds): kernel {k_ms:.1f} ms, plain "
            f"{p_ms:.1f} ms; exact")
    else:
        log(f"[3 ladder] plain version on the whole pass estimated at "
            f"{est_s:.0f} s: compared over phases 1-3 only")
    n, m, K = inp["n"], inp["m"], inp["K"]
    # each input read once (cols, vals_m, nvalid, prices, owner, sigma),
    # each output written once (prices, owner, sigma)
    bound = _bound(8 * n * K + 4 * n + 2 * (8 * m + 4 * n))
    log(f"[3 ladder] bound {bound}")
    return dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=None,
                compared="whole pass" if whole else "phases 1-3", **bound)


def _device_events(prof):
    """The window's device-side events (kernels, copies, memsets).  A CPU
    op's self device time is its kernels' time again, so a sum over every
    event of ``key_averages()`` counts each aten op's kernels twice; a
    record_function range also shows on the device as its span."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages() if e.device_type != DeviceType.CPU
            and not getattr(e, "is_user_annotation", False)]


def _idle_share(inp) -> None:
    """torch.profiler over one cached device pass: the device's busy time
    (the sum of its kernels', copies' and memsets' self time) against the
    window's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res, _ = headline_device_pass(inp)
        torch.cuda.synchronize()
        window_us = 1e6 * (time.perf_counter() - t0)
    events = _device_events(prof)
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:4]
    log(f"[5 headline] profiler, one cached device pass ({res.rounds} "
        f"rounds): window {window_us / 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms, idle share {1 - busy_us / window_us:.3f}; "
        f"top: " + ", ".join(f"{e.key[:40]} "
                             f"{e.self_device_time_total / 1e3:.2f} ms "
                             f"x{e.count}" for e in top))


def _reset_ladder_counts() -> None:
    bid_topk.launches = commit.launches = ladder_phase.launches = 0
    for k in ladder_phase.stats:
        ladder_phase.stats[k] = 0


def _per_round(stats) -> str:
    """The ladder kernel's per-round cost above and below its one-block
    tail, and the stage A (bid + resolve) part of it."""
    parts = []
    for side, label in (("grid", "grid"), ("tail", "one-block tail")):
        r = max(stats[f"{side}_rounds"], 1)
        parts.append(f"{label} rounds {stats[f'{side}_rounds']} at "
                     f"{stats[f'{side}_ns'] / r / 1e3:.2f} us/round (stage A "
                     f"{stats[f'{side}_a_ns'] / r / 1e3:.2f} us)")
    return ", ".join(parts)


def phase_headline(solver, loc, vv, inp):
    n = solver.problem_spec.n
    torch.cuda.synchronize()
    _reset_ladder_counts()
    t0 = time.perf_counter()
    cold = solver.solve()
    cold_s = time.perf_counter() - t0
    launches = {"ladder": ladder_phase.launches}
    k12 = (bid_topk.launches, commit.launches)
    stats = {"cold": dict(ladder_phase.stats)}
    _reset_ladder_counts()
    t0 = time.perf_counter()
    warm = solver.solve()
    warm_s = time.perf_counter() - t0
    stats["cached"] = dict(ladder_phase.stats)
    for name, res, secs in (("cold", cold, cold_s), ("cached", warm,
                                                      warm_s)):
        m = res["meta"]
        log(f"[5 headline] {name}: {secs:.3f} s; device {m['device_time']:.3f}"
            f" s, readback {m['readback_time']:.4f} s, host GS "
            f"{m['host_gs_time']:.3f} s; its {m['its']} (PR 1: 7357; device "
            f"{1e3 * m['device_time'] / m['its']:.4f} ms/round), "
            f"host_bids {m['host_bids']} (PR 1: 957412), phases "
            f"{m['phases']}, obj {m['obj']!r}")
        log(f"[5 headline] {name} tier_rounds {m['tier_rounds']}")
        log(f"[5 headline] {name} ladder kernel: {_per_round(stats[name])}")
    if not (cold["meta"]["soln_found"] and warm["meta"]["soln_found"]):
        raise AssertionError("headline solve found no solution")
    sol = cold["sol"]
    if np.unique(sol).shape[0] != n or sol.min() < 0:
        raise AssertionError("headline solution is not a permutation")
    if not (np.array_equal(sol, warm["sol"])
            and np.array_equal(cold["prices"].view(np.int32),
                               warm["prices"].view(np.int32))):
        raise AssertionError("cached re-solve differs from the cold solve")
    if launches["ladder"] != cold["meta"]["phases"] or k12 != (0, 0):
        raise AssertionError(f"ladder launches {launches['ladder']} for "
                             f"{cold['meta']['phases']} phases; K1, K2 "
                             f"standalone launches {k12} (want 0)")
    _idle_share(inp)
    t0 = time.perf_counter()
    cpu = AuctionSolver(loc=loc, val=vv, shape=(n, n), mode="cpu",
                        cardinality_check=False).solve()
    cpu_s = time.perf_counter() - t0
    gap = abs(cold["meta"]["obj"] - cpu["meta"]["obj"])
    bound = n * cold["meta"]["final_eps"]
    log(f"[5 headline] port mode='cpu': {cpu_s:.3f} s, obj "
        f"{cpu['meta']['obj']!r}; |obj - obj_cpu| = {gap!r} <= n * eps_min "
        f"= {bound!r}: {gap <= bound}")
    if not (cpu["meta"]["soln_found"] and gap <= bound):
        raise AssertionError("headline objective disagrees with mode='cpu'")
    log(f"[5 headline] launches during the cold solve: ladder "
        f"{launches['ladder']} (one per phase), K1 {k12[0]}, K2 {k12[1]}")
    _feasibility_seed(solver.problem_spec)
    head5 = dict(obj_cpu=cpu["meta"]["obj"], cached_s=warm_s,
                 device_time=warm["meta"]["device_time"],
                 its=warm["meta"]["its"])
    return launches, cold["meta"]["its"], head5


def _feasibility_seed(prob) -> None:
    """The device seed of the HK pre-check on the headline: the greedy
    maximal matching on the card against the port on the CPU (bit for
    bit, rounds), then is_feasible with device_seed False and True, each
    the median of SEED_REPS timed calls: equal answers, and the seeded
    HK's matching size equal to the host HK's."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = FD.greedy_matching(prob, device=DEVICE)
    gpu_s = time.perf_counter() - t0
    rounds = FD.greedy_matching_packed.rounds
    t0 = time.perf_counter()
    want = FD.greedy_matching(prob, device="cpu")
    cpu_s = time.perf_counter() - t0
    if not (all(np.array_equal(a, b) for a, b in zip(got, want))
            and FD.greedy_matching_packed.rounds == rounds):
        raise AssertionError("greedy matching: CUDA != CPU")
    log(f"[5 headline] greedy matching (device seed): CUDA {gpu_s:.3f} s == "
        f"CPU {cpu_s:.3f} s bit for bit; {rounds} rounds, matched share "
        f"{float((got[0] >= 0).mean())!r}")
    times, answers = {}, {}
    for seed in (False, True):
        secs = []
        for _ in range(SEED_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            answers[seed] = F.is_feasible(prob, device_seed=seed,
                                          device=DEVICE)
            secs.append(time.perf_counter() - t0)
        times[seed] = float(np.median(secs))
    sizes = [F.hopcroft_karp(prob, device_seed=seed, device=DEVICE)[2]
             for seed in (False, True)]
    log(f"[5 headline] is_feasible: host seed {times[False]:.3f} s, device "
        f"seed {times[True]:.3f} s (median of {SEED_REPS}); answers "
        f"{answers[False]} / {answers[True]}; HK sizes {sizes[0]} / "
        f"{sizes[1]}")
    # the split: CSR, column table, the HK from each seed
    split = {}
    t0 = time.perf_counter()
    indptr, indices = F._ell_to_csr(prob)
    split["csr"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    FD.build_colpack(prob.cols, prob.valid, prob.m)
    split["colpack"] = time.perf_counter() - t0
    for name, init in (("hk_host_seed", None), ("hk_device_seed", got)):
        t0 = time.perf_counter()
        F.hopcroft_karp_csr(indptr, indices, prob.n, prob.m, init_match=init)
        split[name] = time.perf_counter() - t0
    log(f"[5 headline] is_feasible split (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()) + f"; greedy pass on the "
        f"card {gpu_s:.3f} (H2D and D2H included)")
    if answers[False] != answers[True] or sizes[0] != sizes[1] or \
            not answers[False]:
        raise AssertionError("is_feasible: seeded != host")


# ---------------------------------------------------------------------------
# Phase 6: K3 on the headline's tail
# ---------------------------------------------------------------------------


def _events_ms(fn):
    """(result, ms) of one call, CUDA events around it."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def _k3_bound(state, out):
    """K3's bound on one run: each input read once (the queue slots
    popped, the rows that bid, prices and owner at the columns those rows
    hold), each output written once (pushed slots, changed prices and
    owner entries).  No wrap of the ring: popped slots are 0..bids-1."""
    cols_d, _, _, qcount, prices, owner = state[:6]
    K = cols_d.shape[1]
    bids, left = int(out[3]), int(out[4])
    rows = torch.unique(out[2][:bids].long())
    ucols = torch.unique(cols_d[rows]).numel()
    pushes = left + bids - qcount
    changed = int((out[0].view(torch.int32) != prices.view(torch.int32)).sum()
                  + (out[1] != owner).sum())
    return _bound(4 * bids + 8 * K * rows.numel() + 8 * ucols + 4 * pushes
                  + 4 * changed + 16, 3 * K * bids)


def _k3_counters():
    """The last K3 launch's counters, or None for a tree whose K3 keeps
    none (an older commit measured with --k3)."""
    read = getattr(gs_auction_device, "counters", None)
    return None if read is None else read()


def _check_counters(cnt, what):
    """With bid warps, speculative + redone + single-row-ring = bids; the
    ring histogram always adds up to the bids."""
    if cnt is None:
        return
    parts = cnt["speculative"] + cnt["redone"] + cnt["single_row_ring"]
    if sum(cnt["ring"].values()) != cnt["bids"] or (
            cnt["speculative"] + cnt["redone"] > 0 and parts != cnt["bids"]):
        raise AssertionError(f"K3 counters do not add up ({what}): {cnt}")


def tail_state(inp, cold_its=None):
    """The headline's tail: the square hybrid's device pass rebuilt from
    the package's functions, owner derived, the unassigned rows with
    entries queued ascending (the native engine's order).  Returns (the K3
    arguments before max_bids, sigma, the pass's rounds)."""
    t0 = time.perf_counter()
    res, _ = headline_device_pass(inp)
    cols_d, vals_d, nvalid_d = inp["ell"]
    torch.cuda.synchronize()
    if cold_its is not None and res.rounds != cold_its:
        raise AssertionError(f"rebuilt device pass ran {res.rounds} rounds, "
                             f"the cold solve {cold_its}")
    n = res.sigma.shape[0]
    m = res.prices.shape[0]
    dev = res.sigma.device
    sigma, prices = res.sigma, res.prices
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    owner = torch.full((m,), -1, dtype=torch.int32, device=dev)
    assigned = sigma >= 0
    owner[sigma[assigned].long()] = rows[assigned]
    pending = rows[(sigma < 0) & (nvalid_d > 0)]          # ascending
    queue = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    queue[:pending.shape[0]] = pending
    eps = np.float32(inp["e_min"])
    state = (cols_d, vals_d, queue, pending.shape[0], prices, owner, eps,
             inp["bigp"])
    log(f"[6 gs] headline device pass rebuilt: {res.rounds} rounds, "
        f"{pending.shape[0]} rows queued, eps {eps!r}, bigp "
        f"{inp['bigp']!r} ({time.perf_counter() - t0:.2f} s)")
    return state, sigma, res.rounds


def phase_gs(inp, cold_its=None, stubs=True, sweep=()):
    """K3 against its twin, then K3 against the native forward GS, on the
    headline's tail state, with prefetch (the look-ahead bid warps) on and
    off; then (stubs) the reference's _scan stubs on the same state.
    Returns a dict: max abs error vs the twin; ms and ms_noprefetch, one
    call each over the first GS_TWIN_BIDS bids (CUDA events), and the
    twin's plain_ms; the launches of the two tail runs; tail_us_per_bid
    per (scan, prefetch) (whole tail for "full", GS_STUB_BIDS for the
    stubs); whole_tail_us_per_bid and the native forward GS's us/bid; the
    bound over the first GS_TWIN_BIDS bids; each tail run's counters; and
    for each number of bid warps in ``sweep`` (set through the module
    constant, where the tree has one) the whole tail's us/bid and
    counters with prefetch on."""
    state, sigma, rounds = tail_state(inp, cold_its)
    csr, e_min, bigp = inp["csr"], inp["e_min"], inp["bigp"]
    prices, owner = state[4], state[5]
    n = sigma.shape[0]
    want, twin_ms = _events_ms(lambda: gs_auction_plain(*state,
                                                        GS_TWIN_BIDS))
    k3_ms, err, cnt_prefix = {}, 0.0, {}
    for prefetch in (True, False):
        got, k3_ms[prefetch] = _events_ms(lambda: gs_auction_device(
            *state, GS_TWIN_BIDS, prefetch=prefetch))
        if not (_same_bits(got[0], want[0]) and all(
                torch.equal(a, b) for a, b in zip(got[1:], want[1:]))
                and int(got[3]) == GS_TWIN_BIDS):
            raise AssertionError(f"gs_auction_device(prefetch={prefetch}) "
                                 f"differs from its twin")
        err = max(err, _abs_err(got[0], want[0]))
        cnt_prefix[prefetch] = _k3_counters()
        _check_counters(cnt_prefix[prefetch], f"first {GS_TWIN_BIDS} bids")
    bound = _k3_bound(state, want)
    log(f"[6 gs] bound over the first {GS_TWIN_BIDS} bids: {bound}")
    us_per_bid = 1e3 * max(k3_ms.values()) / GS_TWIN_BIDS
    log(f"[6 gs] first {GS_TWIN_BIDS} bids: K3 prefetch {k3_ms[True]:.3f} ms"
        f" ({1e3 * k3_ms[True] / GS_TWIN_BIDS:.3f} us/bid), no prefetch "
        f"{k3_ms[False]:.3f} ms ({1e3 * k3_ms[False] / GS_TWIN_BIDS:.3f} "
        f"us/bid), twin {twin_ms:.3f} ms ({1e3 * twin_ms / GS_TWIN_BIDS:.3f}"
        f" us/bid); exact; counters {cnt_prefix}")

    def native(max_bids):
        p = prices.cpu().numpy().copy()
        s = sigma.cpu().numpy().copy()
        o = owner.cpu().numpy().copy()
        t = time.perf_counter()
        bids = _native.auction_gs(*csr, p, s, o, e_min, bigp, 0, max_bids)
        return p, o, bids, time.perf_counter() - t

    budget = 100 * n + 10_000_000          # the hybrid's finisher budget
    p_nat, o_nat, nat_bids, nat_s = native(budget)
    if nat_bids < 0:
        raise AssertionError("native GS exhausted its budget on the tail")
    cap = budget
    if nat_bids * us_per_bid * 1e-6 > GS_MAX_SECONDS:
        cap = int(GS_MAX_SECONDS * 1e6 / us_per_bid)
        log(f"[6 gs] native ran {nat_bids} bids in {nat_s:.3f} s; K3 would "
            f"need ~{nat_bids * us_per_bid * 1e-6:.0f} s: both capped at "
            f"{cap} bids")
        p_nat, o_nat, nat_bids, nat_s = native(cap)
        nat_bids = cap if nat_bids == -1 else nat_bids
    native_us = 1e6 * nat_s / nat_bids
    log(f"[6 gs] native forward GS on the tail: {nat_bids} bids, "
        f"{nat_s:.3f} s ({native_us:.3f} us/bid)")
    gs_auction_device.launches = 0
    us, cnt_tail, swept = {}, {}, {}
    default_warps = getattr(GK, "BID_WARPS", None)
    runs = [(True, None), (False, None)]
    if default_warps is not None:
        runs += [(True, w) for w in sweep]
    for prefetch, warps in runs:
        if warps is not None:
            GK.BID_WARPS = warps
        t = time.perf_counter()
        try:
            out, k3_full_ms = _events_ms(lambda: gs_auction_device(
                *state, cap, prefetch=prefetch))
        finally:
            if default_warps is not None:
                GK.BID_WARPS = default_warps
        k3_s = time.perf_counter() - t
        k3_bids, left = int(out[3]), int(out[4])
        if not (k3_bids == nat_bids and (left == 0) == (cap == budget)
                and np.array_equal(out[0].cpu().numpy().view(np.int32),
                                   p_nat.view(np.int32))
                and np.array_equal(out[1].cpu().numpy(), o_nat)):
            raise AssertionError(
                f"K3 (prefetch={prefetch}) differs from the native GS on the"
                f" tail (bids {k3_bids} vs {nat_bids}, left {left})")
        cnt = _k3_counters()
        _check_counters(cnt, "the tail")
        log(f"[6 gs] tail, K3 prefetch={prefetch}: {k3_bids} bids in "
            f"{k3_s:.3f} s (events {k3_full_ms:.1f} ms, "
            f"{1e3 * k3_full_ms / k3_bids:.3f} us/bid); rows left {left}; "
            f"prices bitwise, owner and bids equal to native; bid warps "
            f"{getattr(gs_auction_device, 'bid_warps', None)}, counters "
            f"{cnt}")
        if warps is not None:
            swept[warps] = dict(us_per_bid=1e3 * k3_full_ms / k3_bids,
                                bid_warps=gs_auction_device.bid_warps,
                                counters=cnt)
            continue
        cnt_tail[prefetch] = cnt
        us[("full", prefetch)] = 1e3 * k3_full_ms / k3_bids
        if prefetch:
            warps_used = getattr(gs_auction_device, "bid_warps", None)
        if len(cnt_tail) == 2:
            launches = gs_auction_device.launches
    if launches != 2:
        raise AssertionError(f"K3 launched {launches} times on the tail")
    if None not in cnt_tail.values() and (
            cnt_tail[True]["ring"] != cnt_tail[False]["ring"]):
        raise AssertionError("the ring histogram depends on prefetch")

    # The chain's links: "noprices" drops the K price gathers, "const"
    # bids on the first slot after one price read; each stub against its
    # twin over the prefix, then timed over GS_STUB_BIDS bids.
    for scan in ("const", "noprices") if stubs else ():
        want = gs_auction_plain(*state, GS_TWIN_BIDS, _scan=scan)
        for prefetch in (True, False):
            got = gs_auction_device(*state, GS_TWIN_BIDS, prefetch=prefetch,
                                    _scan=scan)
            if not (_same_bits(got[0], want[0]) and all(
                    torch.equal(a, b) for a, b in zip(got[1:], want[1:]))):
                raise AssertionError(f"K3 _scan={scan} prefetch={prefetch} "
                                     f"differs from its twin")
            out, ms = _events_ms(lambda: gs_auction_device(
                *state, GS_STUB_BIDS, prefetch=prefetch, _scan=scan))
            us[(scan, prefetch)] = 1e3 * ms / int(out[3])
            log(f"[6 gs] tail, K3 _scan={scan} prefetch={prefetch}: "
                f"{int(out[3])} bids, {us[(scan, prefetch)]:.3f} us/bid; "
                f"== twin over {GS_TWIN_BIDS} bids")
    return dict(
        max_abs_err=err, ms=k3_ms[True], ms_noprefetch=k3_ms[False],
        plain_ms=twin_ms, launches=launches, bound=bound, rounds=rounds,
        tail_us_per_bid={f"{scan}{'' if pf else ' noprefetch'}": v
                         for (scan, pf), v in us.items()},
        whole_tail_bids=nat_bids,
        whole_tail_us_per_bid={"prefetch": us[("full", True)],
                               "noprefetch": us[("full", False)],
                               "native_forward_gs": native_us},
        bid_warps=warps_used, bid_warps_sweep=swept,
        counters={"tail": cnt_tail[True], "tail noprefetch": cnt_tail[False],
                  "first_20k": cnt_prefix[True]})


# ---------------------------------------------------------------------------
# Phases 7-8: the rectangular hybrid and the Jacobi device path
# ---------------------------------------------------------------------------


def _meta_line(m):
    return (f"its {m['its']}, host_bids {m.get('host_bids')}, phases "
            f"{m['phases']}, obj {m['obj']!r}, final_eps {m['final_eps']!r}")


def phase_rect(n=100_000, m=200_000):
    """Returns the K1 and K2 launches of its hybrid solve: their path since
    the square hybrid's device pass runs the ladder kernel."""
    loc, val = make_sparse(n, m, 10, seed=11, high=10_000)
    kw = dict(loc=loc, val=val, shape=(n, m))
    bid_topk.launches = commit.launches = 0
    t0 = time.perf_counter()
    hy = AuctionSolver(mode="hybrid", device=DEVICE, dtype=np.float32,
                       **kw).solve()
    hy_s = time.perf_counter() - t0
    launches = (bid_topk.launches, commit.launches)
    log(f"[7 rect] {n}x{m}, nnz {loc.shape[0]}: hybrid on the card "
        f"(float32) {hy_s:.3f} s; {_meta_line(hy['meta'])}; launches "
        f"K1 {launches[0]}, K2 {launches[1]}")
    # the same solve on the CPU runs K1's and K2's plain versions
    t0 = time.perf_counter()
    hc = AuctionSolver(mode="hybrid", device="cpu", dtype=np.float32,
                       **kw).solve()
    if not (np.array_equal(hy["sol"], hc["sol"])
            and np.array_equal(hy["prices"].view(np.int32),
                               hc["prices"].view(np.int32))
            and all(hy["meta"][k] == hc["meta"][k]
                    for k in ("its", "phases", "host_bids", "obj"))):
        raise AssertionError("rectangular hybrid: CUDA != CPU")
    log(f"[7 rect] hybrid with device='cpu' (K1, K2 plain) "
        f"{time.perf_counter() - t0:.3f} s: == CUDA bit for bit (sol, "
        f"prices, its, phases, host bids, obj)")
    t0 = time.perf_counter()
    ex = AuctionSolver(mode="cpu", **kw).solve()
    ex_s = time.perf_counter() - t0
    log(f"[7 rect] mode='cpu' (exact, float64) {ex_s:.3f} s; "
        f"{_meta_line(ex['meta'])}")
    t0 = time.perf_counter()
    cf = AuctionSolver(mode="cpu", dtype=np.float32, **kw).solve()
    cf_s = time.perf_counter() - t0
    log(f"[7 rect] mode='cpu' (float32) {cf_s:.3f} s; "
        f"{_meta_line(cf['meta'])}")
    if not (hy["meta"]["soln_found"] and ex["meta"]["soln_found"]
            and cf["meta"]["soln_found"]):
        raise AssertionError("a rectangular solve found no solution")
    if min(launches) <= 0 or launches[0] != hy["meta"]["its"]:
        raise AssertionError(f"rect hybrid launches {launches}, its "
                             f"{hy['meta']['its']}")
    gap = abs(hy["meta"]["obj"] - ex["meta"]["obj"])
    bound = m * hy["meta"]["final_eps"]
    log(f"[7 rect] |obj_hybrid - obj_exact| = {gap!r} <= m * eps_min = "
        f"{bound!r}: {gap <= bound}; equal: {gap == 0}")
    if gap > bound:
        raise AssertionError("rectangular hybrid objective out of bound")
    return {"bid_topk": launches[0], "commit": launches[1]}


def _parity(name, loc, val, shape, **kw):
    """CUDA against CPU, bit for bit.  The Jacobi driver launches K1 and
    K2 once a round; mode='device' on a square problem takes the tiered
    solve, one ladder launch per phase and no K1/K2 launch."""
    _reset_ladder_counts()
    t0 = time.perf_counter()
    g = AuctionSolver(loc=loc, val=val, shape=shape, device=DEVICE,
                      **kw).solve()
    g_s = time.perf_counter() - t0
    launches = (bid_topk.launches, commit.launches, ladder_phase.launches)
    t0 = time.perf_counter()
    c = AuctionSolver(loc=loc, val=val, shape=shape, device="cpu",
                      **kw).solve()
    c_s = time.perf_counter() - t0
    gm, cm = g["meta"], c["meta"]
    if not (np.array_equal(g["sol"], c["sol"])
            and np.array_equal(g["prices"].view(np.int32),
                               c["prices"].view(np.int32))
            and all(gm.get(k) == cm.get(k) for k in (
                "its", "phases", "host_bids", "final_eps", "unassigned",
                "obj"))):
        raise AssertionError(f"port on CUDA != port on CPU ({name})")
    tiered = kw.get("mode") == "device" and shape[0] == shape[1]
    want = ((0, 0, gm["phases"]) if tiered
            else (gm["its"], gm["its"], 0))
    if launches != want or gm["its"] <= 0:
        raise AssertionError(f"{name}: launches (K1, K2, ladder) {launches},"
                             f" want {want}")
    log(f"[8 jacobi] {name}: CUDA {g_s:.3f} s == CPU {c_s:.3f} s (sol, "
        f"prices bitwise, {_meta_line(gm)}); launches K1 {launches[0]}, "
        f"K2 {launches[1]}, ladder {launches[2]}")


def phase_jacobi():
    loc, val = make_sparse(10_000, 20_000, 10, seed=12, high=3000)
    _parity("rect hybrid 10000x20000 int32", loc, val, (10_000, 20_000),
            mode="hybrid")
    _parity("mode='device' 10000x20000 int32, max_iter 1000", loc, val,
            (10_000, 20_000), mode="device", max_iter=1000)
    rr, cc, vv = make_instance(10_000, 10_000, 9, seed=3)
    _parity("mode='device' 10000x10000 float32", np.stack([rr, cc], 1), vv,
            (10_000, 10_000), mode="device")


# ---------------------------------------------------------------------------
# Phase 9: the GS micro-probes (P1-P17)
# ---------------------------------------------------------------------------


PROBE_ITERS = 500_000         # P6 / P9: rows 2i of a [1M, 128] int32 table
PROBE_B2B = 20                # calls queued back to back (ms_device)
LADDER_PLAIN_BIDS = 20_000    # the ladder's plain version on a prefix
LADDER_CONFLICT_BIDS = 200_000  # ... on the conflict instances


def _timed(fn, reps=20):
    """(first result, median CUDA-event ms of fn() over reps calls); a call
    above 50 ms is timed once."""
    out, ms = _events_ms(fn)
    if ms > 50:
        return out, ms
    marks = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        marks.append((t0, t1))
    torch.cuda.synchronize()
    return out, float(np.median([a.elapsed_time(b) for a, b in marks]))


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


# rows read per iteration, 512 bytes each (P13, P15: row 2r + 1 and the
# 32-byte sector of row 2r's first entry)
_QUEUE_ROW_READS = {"while_qtable_dma_store": 16 / 12, "qdma_dual": 2,
                    "qdma_store_datadep": 1 + 32 / 512,
                    "qdma_store_via_dma": 1 + 32 / 512}


def _probe_bound(name, x, out):
    """A probe's bound on its inputs ``x`` and outputs: each output written
    once, and what its loop must read of its inputs once (P1-P3 two
    512-byte rows; P4-P5 the table it copies; P6-P15 a 512-byte row per
    iteration, two where the variant reads two (or a row of each table),
    plus the queue entry and the price / owner entries it reads; P16-P17
    per bid the queue slot, the row's first column and value, the price
    and the owner)."""
    written = sum(t.numel() * t.element_size() for t in out)
    if name.startswith("dma_"):
        read = 2 * PG.LINE * 4
    elif name.startswith("lane_"):
        read = x[1].numel() * 4
    elif name.startswith(("gs_uni", "gs_ladder")):
        read = int(out[-2][0]) * 20
    else:
        n_it = x[0][0]
        per = 4 * PG.LINE * _QUEUE_ROW_READS.get(name, 1)
        if name not in ("while_double_buffer", "sem_2d_dynamic"):
            per += 4
        per += {"qdma_alias3": 8, "qdma_alias2": 4}.get(name, 0)
        read = n_it * per
    return _bound(read + written)


# The queue probes' loops (P7-P15) and the ones that copy rows 2 rid + 1
_LOOP_PROBES = ("while_qtable_dma", "while_qtable_dma_store", "qdma_dual",
                "qdma_alias3", "qdma_alias2", "qdma_store_datadep",
                "qdma_store_bitcast", "qdma_store_via_dma")


def _loop_ids(name, x):
    """The row ids a queue probe's loop reads on the wrapper's arguments
    ``x`` at the reference shapes (n = 12: no position reads a slot the
    loop wrote but P8's pushed ones, q[p mod n] + 20 (p // n) for p in [n,
    n + 4))."""
    n = x[0][0]
    q = (x[3] if name == "qdma_dual" else x[2]).reshape(-1).long()
    ids = q[:n]
    if name == "while_qtable_dma_store" and n:
        p = torch.arange(n, n + 4, device=q.device)
        ids = torch.cat([ids, q[p % n] + 20 * (p // n)])
    return ids


def _probe_copies(name, x):
    """The rows a copy probe copies, as (table, row indices) pairs: P1-P3
    rows row, row + 1; P6, P9 rows 2i, 2i + 1 for i < n; P7-P15 rows 2 rid,
    2 rid + 1 of each position's id (P10: of hbm and of vbm); else None."""
    if name.startswith("dma_"):
        return [(x[1], torch.arange(x[0][0], x[0][0] + 2, device=x[1].device))]
    if name in ("while_double_buffer", "sem_2d_dynamic"):
        return [(x[1], torch.arange(2 * x[0][0], device=x[1].device))]
    if name in _LOOP_PROBES:
        ids = _loop_ids(name, x)
        rows = torch.stack([2 * ids, 2 * ids + 1], dim=1).reshape(-1)
        return [(t, rows) for t in ((x[1], x[2]) if name == "qdma_dual"
                                    else (x[1],))]
    return None


def _probe_library_ms(name, x):
    """One PyTorch call that computes the probe's copy, index_select of
    the rows it copies (P10: one for each table): (median CUDA-event ms
    of one call, device ms per call of PROBE_B2B calls back to back), or
    None for the others."""
    copies = _probe_copies(name, x)
    if copies is None:
        return None
    run = lambda: [torch.index_select(t, 0, r) for t, r in copies]  # noqa
    run()                                       # warm up: first-call setup
    torch.cuda.synchronize()
    return _timed(run)[1], _device_ms(tuple, run, PROBE_B2B)


def _probe_against_plain(name, dev):
    """Probe ``name`` at its reference shapes: kernel == plain version bit
    for bit, the reference's asserts; (max abs error, kernel ms, plain
    ms, bound, library ms, back-to-back ms: {kernel, library} for the
    copy probes, else None)."""
    kernel = PG.PROBES[name]
    plain = PG.plain_of(kernel)
    args, kw = PG.make_inputs(name)
    x = PG.to_device(args, dev)
    got, k_ms = _timed(lambda: _as_tuple(kernel(*x, **kw)))
    want, p_ms = _timed(lambda: _as_tuple(plain(*x, **kw)), reps=3)
    if not (len(got) == len(want) and all(
            a.dtype == b.dtype and a.shape == b.shape and _same_bits(a, b)
            for a, b in zip(got, want))):
        raise AssertionError(f"probe {name}: kernel differs from its plain "
                             f"version")
    PG.check(name, got)
    err = max(_abs_err(a.reshape(-1), b.reshape(-1))
              for a, b in zip(got, want))
    bound = (None if kernel is gs_auction_device
             else _probe_bound(name, x, got))
    lib = None if bound is None else _probe_library_ms(name, x)
    lib_ms, b2b = None, None
    if lib is not None:           # back to back only where the wrapper
        lib_ms = lib[0]           # does not synchronise
        b2b = dict(kernel=_device_ms(tuple, lambda: kernel(*x, **kw),
                                     PROBE_B2B)
                   if name in _B2B_PROBES else None, library=lib[1])
    log(f"[9 probes] {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms; "
        f"exact, the reference's asserts hold; bound {bound}, library "
        f"{lib_ms}, back to back {b2b}")
    return err, k_ms, p_ms, bound, lib_ms, b2b


def _distinct_rows(rows, dev):
    """A [rows, 128] int32 table made on the card, entry (r, c) = 131 r +
    c: every row sums to a different value."""
    return (torch.arange(rows, dtype=torch.int64, device=dev)[:, None] * 131
            + torch.arange(PG.LINE, device=dev)).to(torch.int32)


def _pump_closed_form(n):
    """The sum of rows 2i, i < n, of _distinct_rows, wrapped to int32."""
    return PG._wrap32(131 * 2 * PG.LINE * (n * (n - 1) // 2)
                      + PG.LINE * (PG.LINE - 1) // 2 * n)


def _pump_at_scale(dev):
    """P6 (the pump) at n = 0, 1 and 17 against its plain version and the
    closed form; then P6 and P9 (one function, so both run the pump
    kernel; P9's TPU loop waits for each copy before it starts the next)
    over PROBE_ITERS 2-row copies from a 512 MB table (~10x the L2) of distinct
    rows, turn about, each checked in closed form; P6 and index_select of
    the same rows back to back.  Returns ns/iteration per probe and P6's
    and index_select's ms at scale."""
    for n in (0, 1, 17):
        x = _distinct_rows(2 * n + 2, dev)
        got = PG.while_double_buffer((n,), x)[0]
        want = PG.while_double_buffer.plain((n,), x)[0]
        if not got.tolist() == want.tolist() == [_pump_closed_form(n)]:
            raise AssertionError(f"P6 at n = {n}: {got.tolist()} != "
                                 f"{want.tolist()}")
    hbm = _distinct_rows(2 * PROBE_ITERS, dev)
    closed = _pump_closed_form(PROBE_ITERS)
    ns = {}
    for name in ("while_double_buffer", "sem_2d_dynamic", "sem_2d_dynamic",
                 "while_double_buffer"):
        out, ms = _events_ms(lambda: PG.PROBES[name]((PROBE_ITERS,), hbm))
        if int(out[0][0]) != closed:
            raise AssertionError(f"{name} at scale: acc {int(out[0][0])} != "
                                 f"{closed}")
        ns.setdefault(name, []).append(1e6 * ms / PROBE_ITERS)
    rows = torch.arange(0, 2 * PROBE_ITERS, 2, device=dev)
    pump = lambda: PG.while_double_buffer((PROBE_ITERS,), hbm)  # noqa: E731
    lib = lambda: torch.index_select(hbm, 0, rows)  # noqa: E731
    lib()
    at_scale = dict(ms=_timed(pump, reps=5)[1],
                    ms_device=_device_ms(tuple, pump, 10),
                    library_ms=_timed(lib, reps=5)[1],
                    library_ms_device=_device_ms(tuple, lib, 10),
                    bound_ms=1e3 * PROBE_ITERS * PG.LINE * 4 / HBM_BYTES_PER_S)
    del hbm
    log(f"[9 probes] P6 == plain == closed form at n = 0, 1, 17; "
        f"{PROBE_ITERS} copies of 2 rows from a {2 * PROBE_ITERS} x 128 "
        f"int32 table of distinct rows: P6 "
        f"{ns['while_double_buffer']} ns/iter, P9 "
        f"{ns['sem_2d_dynamic']} ns/iter; closed form holds; P6 rows 2i "
        f"{at_scale}")
    return ns, at_scale


def _ladder_check(kernel, x, kw, what):
    got, want = kernel(*x, **kw), kernel.plain(*x, **kw)
    torch.cuda.synchronize()
    if not all(_same_bits(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{kernel.name} {what}: kernel != plain")
    return int(got[-2][0])


def _ladder_conflicts(dev, kernel, n, K):
    """P16/P17, stages 1-3, on the two instances whose first columns
    repeat (ladder_inputs first="mod": u mod 65,536; "three": three queued
    rows on one column): kernel == plain over LADDER_CONFLICT_BIDS bids (or
    all the stage has: three bids at stages 1-2 of "three"), then ns/bid
    over max_bids = n.  {instance: {stage: ns/bid}}, and P16's counters."""
    out, counters = {}, {}
    for first in ("mod", "three"):
        for stage in (1, 2, 3):
            kw = dict(K=K, stage=stage)
            args, _ = PG.ladder_inputs(n, n, K, n + 1, unified=kernel is
                                       PG.gs_ladder_uni, stage=stage,
                                       max_bids=LADDER_CONFLICT_BIDS,
                                       first=first)
            x = PG.to_device(args, dev)
            checked = _ladder_check(kernel, x, kw, f"{first} stage {stage}")
            x = (x[0][:1] + (n,) + x[0][2:], *x[1:])
            res, ms = _events_ms(lambda: kernel(*x, **kw))
            bids = int(res[-2][0])
            # a run of three bids times the launch, not a bid: none
            per = 1e6 * ms / bids if bids >= LADDER_PLAIN_BIDS else None
            out.setdefault(first, {})[str(stage)] = per
            cnt = _ladder_counters(kernel)
            if cnt is not None:
                counters[f"{kernel.name} {first} {stage}"] = cnt
            log(f"[9 probes] {kernel.name} first={first} stage {stage}: "
                f"== plain over {checked} bids; {ms:.3f} ms over {bids} "
                f"bids ({per} ns/bid)")
    return out, counters


def _ladder_counters(kernel):
    """The counters of ``kernel``'s last launch (P16, P17), or None where
    the tree keeps none for it (an older tree keeps only P16's)."""
    read = getattr(PG, "ladder_counters", None)
    if read is None:
        return None
    if "kernel" in inspect.signature(read).parameters:
        return read(kernel)
    return read() if kernel is PG.gs_ladder_uni else None


def _ladder_at_scale(dev, n=N_HEAD, K=K_HEAD):
    """P16/P17, stages 1-3, at the headline's shape: rows 0..n-1 queued
    ascending, cols[:, 0] = row id (no evictions), random prices p0.
    Kernel == plain over the first LADDER_PLAIN_BIDS bids; the full run
    checked in closed form; then the conflict instances (a tree whose
    ladder_inputs has no ``first`` skips them).  Returns ({(kernel name,
    stage): ns/bid}, {kernel name: conflict ns/bid}, P16's counters)."""
    p0 = (np.random.default_rng(4).random(n) * 10).astype(np.float32)
    p0_d = torch.from_numpy(p0).to(dev)
    ns, conflicts, counters = {}, {}, {}
    for unified in (True, False):
        kernel = PG.gs_ladder_uni if unified else PG.gs_ladder
        args, _ = PG.ladder_inputs(n, n, K, n + 1, unified=unified, stage=1,
                                   max_bids=10 * n, prices=p0)
        # acc = ((acc + p0[u]) + vals[u, 0]) over u ascending, in float32
        v0 = args[2].reshape(-1)[:n * K:K]
        acc = np.add.accumulate(np.stack([p0, v0], 1).reshape(-1))[-1:]
        x = PG.to_device(args, dev)
        prefix = ((n, LADDER_PLAIN_BIDS, n + 1), *x[1:])
        for stage in (1, 2, 3):
            kw = dict(K=K, stage=stage)
            _ladder_check(kernel, prefix, kw,
                          f"stage {stage} over {LADDER_PLAIN_BIDS} bids")
            out, ms = _events_ms(lambda: kernel(*x, **kw))
            cnt = _ladder_counters(kernel)
            if cnt is not None:
                counters[f"{kernel.name} arange {stage}"] = cnt
            if unified:
                q, p, o = out[0][0], out[0][1].view(torch.float32), out[0][2]
                q0 = x[3][0]
            else:
                q, p, o = (t.reshape(-1) for t in out[:3])
                q0 = x[3].reshape(-1)
            p_want = p0_d if stage == 1 else p0_d + np.float32(0.5)
            o_want = (torch.full((n,), -1, dtype=torch.int32, device=dev)
                      if stage == 1 else torch.arange(
                          n, dtype=torch.int32, device=dev))
            if not (out[-2].tolist() == [n, 0] and torch.equal(q, q0)
                    and _same_bits(p[:n], p_want) and torch.equal(o[:n],
                                                                  o_want)
                    and np.array_equal(out[-1].cpu().numpy().view(np.int32),
                                       acc.view(np.int32))):
                raise AssertionError(f"{kernel.name} stage {stage} at n = "
                                     f"{n}: not the closed form")
            ns[(kernel.name, stage)] = 1e6 * ms / n
            log(f"[9 probes] {kernel.name} stage {stage}, n = m = {n}, K = "
                f"{K}: {ns[(kernel.name, stage)]:.1f} ns/bid ({ms:.1f} ms); "
                f"== plain over {LADDER_PLAIN_BIDS} bids, closed form holds")
        del x, prefix
        if "first" in inspect.signature(PG.ladder_inputs).parameters:
            conflicts[kernel.name], more = _ladder_conflicts(dev, kernel, n,
                                                             K)
            counters.update(more)
    return ns, conflicts, counters


def _sm_clock_mhz():
    """The card's maximum SM clock (nvidia-smi), MHz."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return float(smi.stdout.split()[0])


def _ladder_bounds(n, ns_per_bid):
    """P16/P17's two bounds at n bids: bytes (20 a bid, each read once,
    and the tables written) over the memory rate, and the float32 chain,
    two dependent adds a bid at 4 cycles each at the card's maximum SM
    clock; the share of each a run at ns_per_bid reaches."""
    chain_ns = 8e3 / _sm_clock_mhz()
    bytes_ms = 1e3 * (20 * n + 4 * 3 * n + 8) / HBM_BYTES_PER_S
    run_ms = 1e-6 * ns_per_bid * n
    return dict(bytes_bound_ms=bytes_ms, chain_bound_ms=1e-6 * chain_ns * n,
                bytes_share=bytes_ms / run_ms,
                chain_share=1e-6 * chain_ns * n / run_ms)


def _ladder_device_ms(name, dev):
    """Device time per launch of probe ``name``'s ladder kernel (P16 or
    P17, the reference shape), PROBE_B2B launches back to back: the
    kernel's launch alone (_ladder_cuda), since the wrapper's index checks
    read the tables back (each a synchronisation); every launch gets its
    own copy of the state tables, made before the timed window."""
    args, kw = PG.make_inputs(name)
    x = PG.to_device(args, dev)
    kernel = PG.PROBES[name]
    unified = kernel is PG.gs_ladder_uni
    counts = PG._ladder_args(x[0], x[1], x[2], *PG._views(unified, x[3:]),
                             kw["K"], kw["stage"])

    # an older tree's _ladder_cuda also takes the layout
    lead = (kw["stage"], unified) if "unified" in inspect.signature(
        PG._ladder_cuda).parameters else (kw["stage"],)

    def run(*tables):
        PG._ladder_cuda(*lead, counts, x[1], x[2],
                        *PG._views(unified, tables), kw["K"])
    return _device_ms(lambda: [t.clone() for t in x[3:]], run, PROBE_B2B)


def _kernel_us(fn, reps=PROBE_B2B):
    """torch.profiler over reps calls of fn: each kernel's device time per
    call, us, by name (the split of a back-to-back time into kernel and
    launch gap)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / reps
            for e in prof.key_averages() if e.self_device_time_total > 0}


# Probes whose wrapper does not synchronise (P1-P6, P9): timed back to back
_B2B_PROBES = ("dma_hbm_dynrows", "dma_vmem_dynoff2", "dma_vmem_dynoff8",
               "lane_read_write", "lane_read_write_2d", "while_double_buffer",
               "sem_2d_dynamic")
STORE_N = 2 ** 20             # P15 at scale: positions (and queue entries)
STORE_PAIRS = 2 ** 18         # ... row pairs (hbm [2**19, 128], 256 MB)
STORE_PLAIN = 20_000          # ... against the plain version on a prefix


def _own_kernel_us(fn, reps=PROBE_B2B):
    """Device time per launch, us, of this repository's kernels (in
    anonymous namespaces) that fn launches (a probe call launches one),
    from torch.profiler over reps calls: a synchronising wrapper's kernel
    time without its host work.  Per launch the profiler recorded, so a
    dropped event does not lower it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total / e.count
               for e in prof.key_averages()
               if "anonymous namespace" in e.key and e.count)


def _launch_floor_us(dev):
    """An empty kernel's device time per launch, us, as _own_kernel_us
    takes it; None for a tree without one."""
    lib = _build.load()
    if not hasattr(lib, "sslap_empty"):
        return None
    stream = torch.cuda.current_stream(dev).cuda_stream
    return _own_kernel_us(lambda: _build.check(lib.sslap_empty(stream),
                                               "empty kernel"))


def _probe_device(name, dev):
    """Probe ``name`` at the reference shape: its kernel's device time per
    call (kernel_us, profiler), beside that of index_select's kernels on
    the rows it copies (library_kernel_us, where it copies rows) and, where
    the wrapper does not synchronise, the device time per call of
    PROBE_B2B calls back to back (ms_device; P16-P17 through their launch
    alone)."""
    kernel = PG.PROBES[name]
    args, kw = PG.make_inputs(name)
    x = PG.to_device(args, dev)
    run = lambda: kernel(*x, **kw)  # noqa: E731
    out = dict(kernel_us=_own_kernel_us(run))
    copies = _probe_copies(name, x)
    if copies is not None:        # kernels only: an aten:: operator's
        split = _kernel_us(       # device time repeats its kernels'
            lambda: [torch.index_select(t, 0, r) for t, r in copies])
        out["library_kernel_us"] = sum(
            us for key, us in split.items()
            if not key.startswith(("aten::", "Activity Buffer")))
    if name in _B2B_PROBES:
        out["ms_device"] = _device_ms(tuple, run, PROBE_B2B)
    elif name.startswith(("gs_uni", "gs_ladder")):
        out["ms_device"] = _ladder_device_ms(name, dev)
    return out


def _store_closed_form(q, first, sums, n):
    """P15's result in numpy: the loop for positions below 96 (they may
    read slots it wrote), then for the rest the exclusive prefix sum of
    row sums and, per slot 64..95, its last writer.  (q after, out, the
    number of distinct row ids read)."""
    q = q.copy()
    acc = np.uint32(0)
    head = []
    with np.errstate(over="ignore"):
        for i in range(min(n, 96)):
            rid = q[i]
            head.append(rid)
            q[64 + (first[rid] & 31)] = (acc + np.uint32(7)).view(np.int32)
            acc = acc + sums[rid]
        rid = q[96:n]
        distinct = np.unique(np.concatenate([head, rid])).size
        s = sums[rid]
        pref = acc + np.concatenate([[np.uint32(0)],
                                     np.cumsum(s, dtype=np.uint32)[:-1]])
        tgt = 64 + (first[rid] & 31)
        for t in range(64, 96):
            hit = np.flatnonzero(tgt == t)
            if hit.size:
                q[t] = (pref[hit[-1]] + np.uint32(7)).view(np.int32)
        out = acc + s.sum(dtype=np.uint32)
    return q, np.array([out]).view(np.int32), distinct


def _store_device_ms(hbm, q, n):
    """P15's kernel alone (sslap_probe_store, no error read back), PROBE_B2B
    launches back to back, each on its own copy of the queue: device ms
    per launch; None for a tree without that entry point."""
    lib = _build.load()
    if not hasattr(lib, "sslap_probe_store"):
        return None
    blocks = PG.store_blocks(n)
    stream = torch.cuda.current_stream(hbm.device).cuda_stream

    def prepare():
        return (q.clone(), torch.empty(3, dtype=torch.int32, device=q.device),
                torch.empty(PG.STORE_RECORD * blocks, dtype=torch.int32,
                            device=q.device),
                torch.zeros(1, dtype=torch.int32, device=q.device))

    def run(qq, out, scratch, arrived):
        _build.check(lib.sslap_probe_store(
            hbm.data_ptr(), qq.data_ptr(), n, hbm.shape[0] // 2,
            PG.STORE_SEGMENT, blocks, scratch.data_ptr(), arrived.data_ptr(),
            out.data_ptr(), stream), "qdma_store_via_dma")
    return _device_ms(prepare, run, PROBE_B2B)


def _store_at_scale(dev):
    """P15 at STORE_N positions over STORE_PAIRS row pairs: kernel ==
    plain version (on CPU copies) over STORE_PLAIN positions, kernel ==
    the numpy form over all; one call's time (events), the kernel's device
    time back to back (ms_device) and from the profiler (kernel_ms; one
    call's events where a call takes over 50 ms), against two byte bounds:
    each row pair the run reads once (bound_ms: the queue slots, 512 bytes
    of row 2r + 1 and the 32-byte sector of row 2r's first entry per
    distinct pair, the row written) and per position (bound_ms_per_position:
    4 + 32 + 512 bytes a position, as if no pair repeated)."""
    kernel = PG.qdma_store_via_dma
    hbm, q = PG.to_device(PG.store_inputs(STORE_N, STORE_PAIRS, 9), dev)
    hc, qc = hbm.cpu(), q.cpu()
    got = kernel((STORE_PLAIN,), hbm, q)
    want = kernel.plain((STORE_PLAIN,), hc, qc)
    if not all(torch.equal(a.cpu(), b) for a, b in zip(got, want)):
        raise AssertionError(f"P15 over {STORE_PLAIN} positions: kernel != "
                             f"plain")
    first = hc[0::2, 0].numpy()
    sums = hc[1::2].sum(dim=1).numpy().astype(np.uint32)   # wraps
    q_want, out_want, distinct = _store_closed_form(qc.numpy(), first, sums,
                                                    STORE_N)
    res, ms = _events_ms(lambda: kernel((STORE_N,), hbm, q))
    if not (np.array_equal(res[0].cpu().numpy(), q_want)
            and np.array_equal(res[1].cpu().numpy(), out_want)):
        raise AssertionError(f"P15 at n = {STORE_N}: not the closed form")
    kernel_ms = (ms if ms > 50 else 1e-3 * _own_kernel_us(
        lambda: kernel((STORE_N,), hbm, q), reps=5))
    ms_device = None if ms > 50 else _store_device_ms(hbm, q, STORE_N)
    per_position = 1e3 * (STORE_N * (4 + 32 + 512) + 4 * PG.LINE) / \
        HBM_BYTES_PER_S
    bound = _bound(4 * STORE_N + distinct * (512 + 32) + 4 * PG.LINE + 4)
    timed = ms_device or kernel_ms
    out = dict(ms=ms, kernel_ms=kernel_ms, ms_device=ms_device,
               distinct_pairs=distinct, **bound,
               bound_share=bound["bound_ms"] / timed,
               bound_ms_per_position=per_position,
               per_position_share=per_position / timed)
    log(f"[9 probes] P15 at n = {STORE_N} over {STORE_PAIRS} row pairs: "
        f"== plain over {STORE_PLAIN} positions, == the numpy form; {out}")
    return out


# P7, P10 and P11 at STORE_N positions: their tables in the wrappers' order
_QUEUE_SCALE = {"while_qtable_dma": ("hbm", "q"),
                "qdma_dual": ("hbm", "vbm", "q"),
                "qdma_alias3": ("hbm", "q", "pt", "ot")}


def _queue_scale_tables(dev):
    """P7, P10 and P11's instance at STORE_N positions over STORE_PAIRS row
    pairs: store_inputs' hbm and q (P15's, seed 9) and, made on the card
    from seed 10, vbm (hbm's shape, f32 integers in [-64, 64): every
    partial row sum exact, in any order), pt (STORE_PAIRS f32 integers in
    [-10**6, 10**6)) and ot (STORE_PAIRS int32)."""
    hbm, q = PG.to_device(PG.store_inputs(STORE_N, STORE_PAIRS, 9), dev)
    g = torch.Generator(device=dev)
    g.manual_seed(10)
    draw = lambda lo, hi, shape: torch.randint(  # noqa: E731
        lo, hi, shape, generator=g, device=dev, dtype=torch.int64)
    return dict(hbm=hbm, q=q,
                vbm=draw(-64, 64, hbm.shape).to(torch.float32),
                pt=draw(-10 ** 6, 10 ** 6, (STORE_PAIRS,)).to(torch.float32),
                ot=draw(-2 ** 31, 2 ** 31, (STORE_PAIRS,)).to(torch.int32))


@np.errstate(over="ignore")
def _queue_forms(tables):
    """P7, P10 and P11's out in numpy over all STORE_N positions: the
    wrapped sums of row 2 rid (uint32), of the vbm row sums (exact integers,
    to int32) and of int32(pt) and ot at each position's id; and the
    number of distinct ids."""
    ids = tables["q"][:STORE_N].cpu().numpy()
    rows = tables["hbm"][0::2].cpu().numpy().view(np.uint32).sum(
        axis=1, dtype=np.uint32)[ids].sum(dtype=np.uint32)
    vsum = tables["vbm"][0::2].double().sum(dim=1).to(torch.int32)
    vsum = vsum.cpu().numpy().view(np.uint32)[ids].sum(dtype=np.uint32)
    pt = tables["pt"].to(torch.int32).cpu().numpy().view(np.uint32)
    ot = tables["ot"].cpu().numpy().view(np.uint32)
    extra = pt[ids].sum(dtype=np.uint32) + ot[ids].sum(dtype=np.uint32)
    forms = {"while_qtable_dma": rows, "qdma_dual": rows + vsum,
             "qdma_alias3": rows + extra}
    return ({k: np.array([v]).view(np.int32) for k, v in forms.items()},
            np.unique(ids).size)


def _queue_device_ms(name, args):
    """P7, P10 or P11's pass kernel alone (sslap_probe_queue, no error word
    read back), PROBE_B2B launches back to back at STORE_N positions (the
    tables are only read): device ms per launch; None for a tree without
    the pass kernel."""
    if not hasattr(PG, "QUEUE_SEGMENT"):
        return None
    lib = _build.load()
    t = dict(zip(_QUEUE_SCALE[name], args))
    variant = PG._QUEUE_VARIANTS[name]
    blocks = PG.queue_blocks(PG.queue_total(variant, STORE_N))
    limit = t["hbm"].shape[0] // 2
    if "pt" in t:
        limit = min(limit, t["pt"].numel())
    ptr = lambda k: t[k].data_ptr() if k in t else 0  # noqa: E731
    stream = torch.cuda.current_stream(t["hbm"].device).cuda_stream

    def prepare():
        return (torch.tensor([0, PG.NO_BAD], dtype=torch.int64,
                             device=t["hbm"].device),)

    def run(out):
        _build.check(lib.sslap_probe_queue(
            variant, ptr("hbm"), ptr("vbm"), ptr("q"), ptr("pt"), ptr("ot"),
            STORE_N, limit, PG.QUEUE_SEGMENT, blocks, out.data_ptr(),
            stream), name)
    return _device_ms(prepare, run, PROBE_B2B)


def _queue_at_scale(dev):
    """P7, P10 and P11 at STORE_N positions over STORE_PAIRS row pairs
    (_queue_scale_tables): kernel == plain version (on CPU copies) over
    STORE_PLAIN positions, kernel == the numpy form over all (the tables
    unchanged); one call's time (events), the kernel's device time back to
    back (ms_device) and from the profiler (kernel_ms; one call's events
    where a call takes over 50 ms), against two byte bounds: per position
    (bound_ms_per_position: the id's 4 bytes and 512 of row 2 rid, P10 also
    512 of its vbm row, P11 a 32-byte sector each of the price and the
    owner) and each distinct row pair read once (bound_ms: the ids, and per
    distinct id 512 bytes, P10 1024, P11 512 + 8).  {name: numbers}."""
    tables = _queue_scale_tables(dev)
    forms, distinct = _queue_forms(tables)
    host = {k: t.cpu() for k, t in tables.items()}
    out = {}
    for name, order in _QUEUE_SCALE.items():
        kernel = PG.PROBES[name]
        args = [tables[k] for k in order]
        got = kernel((STORE_PLAIN,), *args)
        want = kernel.plain((STORE_PLAIN,), *(host[k] for k in order))
        if not all(_same_bits(a.cpu(), b) for a, b in zip(got, want)):
            raise AssertionError(f"{name} over {STORE_PLAIN} positions: "
                                 f"kernel != plain")
        res, ms = _events_ms(lambda: kernel((STORE_N,), *args))
        same = zip(res[:-1], (tables[k] for k in order
                              if k not in ("hbm", "vbm")))
        if not (np.array_equal(res[-1].cpu().numpy(), forms[name])
                and all(_same_bits(a, b.reshape(a.shape)) for a, b in same)):
            raise AssertionError(f"{name} at n = {STORE_N}: not the numpy "
                                 f"form")
        kernel_ms = (ms if ms > 50 else 1e-3 * _own_kernel_us(
            lambda: kernel((STORE_N,), *args), reps=5))
        ms_device = None if ms > 50 else _queue_device_ms(name, args)
        row = {"qdma_dual": 1024, "qdma_alias3": 512 + 64}.get(name, 512)
        per_position = 1e3 * (STORE_N * (4 + row) + 4) / HBM_BYTES_PER_S
        once = {"qdma_dual": 1024, "qdma_alias3": 512 + 8}.get(name, 512)
        bound = _bound(4 * STORE_N + distinct * once + 4)
        timed = ms_device or kernel_ms
        out[name] = dict(ms=ms, kernel_ms=kernel_ms, ms_device=ms_device,
                         distinct_pairs=distinct, **bound,
                         bound_share=bound["bound_ms"] / timed,
                         bound_ms_per_position=per_position,
                         per_position_share=per_position / timed)
        log(f"[9 probes] {name} at n = {STORE_N} over {STORE_PAIRS} row "
            f"pairs: == plain over {STORE_PLAIN} positions, == the numpy "
            f"form; {out[name]}")
    return out


def probe_timings():
    """Phase 9's probe measurements: P6 back to back at the probe's shape
    beside index_select, an empty kernel's device time (the launch floor),
    every probe kernel's device time per call at the reference shape, P15
    at scale, P6 and P9 at scale, P16 and P17 at n = m = 1M (closed form
    and conflict instances)."""
    dev = torch.device(DEVICE)
    out = {}
    args, _ = PG.make_inputs("while_double_buffer")
    x = PG.to_device(args, dev)
    rows = _probe_copies("while_double_buffer", x)[0][1]
    out["while_double_buffer"] = dict(
        ms_device=_device_ms(tuple, lambda: PG.while_double_buffer(*x),
                             PROBE_B2B),
        library_ms_device=_probe_library_ms("while_double_buffer", x)[1],
        kernel_us=_kernel_us(lambda: PG.while_double_buffer(*x)),
        library_kernel_us=_kernel_us(
            lambda: torch.index_select(x[1], 0, rows)))
    out["launch_floor_us"] = _launch_floor_us(dev)
    out["probe_device"] = {key: _probe_device(_probe_names(kernel)[-1], dev)
                           for key, kernel in PG.KERNELS.items()}
    out["store_scale"] = _store_at_scale(dev)
    out["queue_scale"] = _queue_at_scale(dev)
    out["pump"], out["pump_500k"] = _pump_at_scale(dev)
    ns, conflicts, counters = _ladder_at_scale(dev)
    out["ladder_ns_per_bid_1M"] = {f"{k} {s}": v for (k, s), v in ns.items()}
    out["ladder_conflicts_ns_per_bid"] = conflicts
    out["ladder_counters"] = counters
    out["ladder_bounds_stage3"] = {k: _ladder_bounds(N_HEAD, ns[(k, 3)])
                                   for k in ("gs_ladder_uni", "gs_ladder")}
    return out


def _probe_names(kernel):
    """The probes a kernel runs, in registry order."""
    return [nm for nm, k in PG.PROBES.items() if k is kernel]


def phase_probes():
    """The probe suite through its entry point (launch counts zeroed
    around it), then each probe against its plain version, then the scaled
    runs.  Returns the {"kernels"} entries of P1-P17."""
    dev = torch.device(DEVICE)
    for k in PG.KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    PG.main([])
    launches = {key: k.launches for key, k in PG.KERNELS.items()}
    log(f"[9 probes] suite (python -m sslap_tpu_torch.ops.probe_gs) in "
        f"{time.perf_counter() - t0:.2f} s; launches {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a probe kernel was not launched: {launches}")
    per_probe = {name: _probe_against_plain(name, dev) for name in PG.ORDER}
    floor_us = _launch_floor_us(dev)
    store_scale = _store_at_scale(dev)
    queue_scale = _queue_at_scale(dev)
    pump, pump_500k = _pump_at_scale(dev)
    ladder, conflicts, counters = _ladder_at_scale(dev)
    entries = []
    for key, kernel in PG.KERNELS.items():
        names = _probe_names(kernel)
        _, k_ms, p_ms, bound, lib_ms, b2b = per_probe[names[-1]]
        device = _probe_device(names[-1], dev)
        entry = dict(name=f"{key} {kernel.name}", route="cuda",
                     source=kernel.source, replaces=kernel.replaces,
                     launches=launches[key],
                     max_abs_err=max(per_probe[nm][0] for nm in names),
                     ms=k_ms, plain_ms=p_ms, **bound, library_ms=lib_ms)
        entry.update(device)
        if b2b is not None:
            if b2b["kernel"] is not None:
                entry["ms_device"] = b2b["kernel"]
            entry["library_ms_device"] = b2b["library"]
        if kernel is PG.qdma_store_via_dma:
            entry["launch_floor_us"] = floor_us
            entry["scale_2e20"] = store_scale
        if kernel.name in queue_scale:
            entry["scale_2e20"] = queue_scale[kernel.name]
        if kernel.name in pump:
            entry["ns_per_iter_500k"] = pump[kernel.name]
        if kernel is PG.while_double_buffer:
            entry["rows_500k"] = pump_500k
        if kernel in (PG.gs_ladder_uni, PG.gs_ladder):
            entry["ns_per_bid_1M"] = {str(s): ladder[(kernel.name, s)]
                                      for s in (1, 2, 3)}
            entry["conflicts_ns_per_bid_1M"] = conflicts.get(kernel.name)
            entry["bounds_1M_stage3"] = _ladder_bounds(
                N_HEAD, ladder[(kernel.name, 3)])
            entry["counters_1M"] = {k[len(kernel.name) + 1:]: v for k, v in
                                    counters.items()
                                    if k.startswith(kernel.name + " ")}
            entry["gather_warps"] = PG.GATHER_WARPS
        entries.append(entry)
    return entries


# ---------------------------------------------------------------------------
# Phase 10: the batched solves at BASELINE config 3
# ---------------------------------------------------------------------------


B3, N3, NNZ3 = 256, 4096, 48  # config 3: 256 independent 4096 x 4096 LAPs
CHUNK3 = 32                   # the dense engine's chunk at 2 GiB of A


def config3_batch():
    """BASELINE config 3 as benchmarks/run_all.py:115-129 builds it:
    make_sparse(4096, 4096, 48, seed=100 + b), float32 costs,
    from_coo(pad_to=52), stacked."""
    t0 = time.perf_counter()
    probs = []
    for b in range(B3):
        loc, val = make_sparse(N3, N3, NNZ3, seed=100 + b, integer=False)
        probs.append(from_coo(loc, val, shape=(N3, N3), pad_to=NNZ3 + 4))
    batch = stack_problems(probs)
    log(f"[10 batch] config 3: {B3} x {N3}x{N3}, nnz {batch.nnz} "
        f"({batch.nnz / B3:.0f}/instance), K {batch.K}; instances + ingest "
        f"+ stack {time.perf_counter() - t0:.2f} s")
    return batch


def _dense_chunk(batch, dev):
    """Chunk 0 of the dense engine on the card (its dense block as the
    engine builds it), with a mid-solve-like state: random prices in the
    value range, a third of the rows assigned, the schedule's eps."""
    lo, hi = 0, CHUNK3
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    blk = DB._dense_from_ell(t(batch.cols[lo:hi]), -t(batch.vals[lo:hi]),
                             t(batch.valid[lo:hi]), N3)
    nvalid = t(batch.nvalid[lo:hi].reshape(-1).astype(np.int32))
    rng = np.random.default_rng(5)
    prices = t((rng.random(CHUNK3 * N3) * 500).astype(np.float32))
    sigma = np.where(rng.random(CHUNK3 * N3) < 0.3,
                     rng.integers(0, N3, CHUNK3 * N3), -1).astype(np.int32)
    eps = t(np.full(CHUNK3, np.float32(0.97)))
    return blk, nvalid, prices, t(sigma), eps, np.float32(1000.0)


def _dense_bid_check(batch, dev):
    """DK against its plain version on chunk 0 (C = all 131,072 rows, then
    256 sorted rows with pads), exact on targets, bids and row maxima;
    timed with CUDA events.  Returns the kernels-line numbers."""
    blk, nvalid, prices, sigma, eps, bigp = _dense_chunk(batch, dev)
    N = CHUNK3 * N3
    rng = np.random.default_rng(6)
    part = np.full(320, N, np.int32)
    part[:256] = np.sort(rng.choice(N, 256, replace=False))
    out = {}
    for ids in (torch.arange(N, dtype=torch.int32, device=dev),
                torch.from_numpy(part).to(dev)):
        C = ids.shape[0]
        args = (ids, blk, nvalid, prices, sigma, eps, bigp)
        got = dense_bid(*args, with_v1=True)
        want = dense_bid_plain(*args, with_v1=True)
        torch.cuda.synchronize()
        if not all(_same_bits(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"dense_bid kernel != plain at C={C}")
        err = max(_abs_err(a, b) for a, b in zip(got[1:], want[1:]))
        reps = 20 if C == N else 200
        ms = _median_ms(lambda: (), lambda: dense_bid(*args), reps)
        plain_ms = _median_ms(lambda: (), lambda: dense_bid_plain(*args), 3)
        live = int((ids < N).sum())
        # each input read once: ids, the live rows of A, the chunk's prices,
        # nvalid + sigma + eps of the live rows; outputs tgt and bid
        bound = _bound(4 * C + 4 * live * N3 + 4 * CHUNK3 * N3 + 12 * live
                       + 8 * C)
        log(f"[10 batch] dense_bid C={C} ({live} rows of {N3} columns, "
            f"{int((got[0] < CHUNK3 * N3).sum())} bids): kernel {ms:.4f} ms,"
            f" plain {plain_ms:.4f} ms, {bound}: "
            f"{bound['bound_ms'] / ms:.1%} of the bound; exact")
        out[C] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound)
    return out


def batched_k1_args(batch, B, dev):
    """K1's batched-entry arguments on the flattened ELL of the first B
    instances: every row bids, random prices, per-instance eps and bigp."""
    _, n, K = batch.cols.shape
    valid = batch.valid[:B]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    base = (np.arange(B, dtype=np.int32) * n)[:, None, None]
    cols = t((batch.cols[:B] + base).reshape(B * n, K))
    vals_m = t(np.where(valid, -batch.vals[:B],
                        neg_sentinel_np(np.float32)).reshape(B * n, K))
    nvalid = t(batch.nvalid[:B].reshape(-1).astype(np.int32))
    rng = np.random.default_rng(7)
    prices = t((rng.random(B * n) * 500).astype(np.float32))
    sigma = torch.full((B * n,), -1, dtype=torch.int32, device=dev)
    owner = torch.full((B * n,), -1, dtype=torch.int32, device=dev)
    eps = t((rng.random(B) + 0.5).astype(np.float32))
    vmax = np.where(valid, -batch.vals[:B], -np.inf).max(axis=(1, 2))
    vmin = np.where(valid, -batch.vals[:B], np.inf).min(axis=(1, 2))
    bigp = t((vmax - vmin + 1).astype(np.float32))
    ids = torch.arange(B * n, dtype=torch.int32, device=dev)
    return (ids, cols, vals_m, nvalid, prices, sigma, owner, eps, bigp, n)


def _batched_k1_check(batch, dev):
    """K1's batched entry against its plain version, exact, on the
    flattened ELL of a chunk of 32 instances (the pass mode='device' runs:
    131,072 rows, eps and bigp arrays of 32) and of all 256 instances
    (1,048,576 rows); every row bids, per-instance eps and bigp.  Timed
    as single calls (ms) and back to back (ms_device).  Returns the chunk's
    numbers, the whole batch's beside them as all_*."""
    out = {}
    for B in (CHUNK3, batch.cols.shape[0]):
        args = batched_k1_args(batch, B, dev)
        cols, valid = args[1], batch.valid[:B]
        n, K = args[-1], cols.shape[1]
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
        got = bid_topk_batched(*args)
        want = bid_topk_batched_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0])
                and _same_bits(got[1], want[1])):
            raise AssertionError(f"bid_topk_batched != its plain version "
                                 f"({B} instances)")
        ms = _median_ms(lambda: (), lambda: bid_topk_batched(*args), 20)
        ms_device = _device_ms(lambda: (), lambda: bid_topk_batched(*args),
                               20)
        plain_ms = _median_ms(lambda: (),
                              lambda: bid_topk_batched_plain(*args), 3)
        C = B * n
        ucols = torch.unique(cols[t(valid.reshape(C, K))]).numel()
        bound = _bound(4 * C + C * (8 * K + 4) + 4 * ucols + 8 * B + 8 * C,
                       3 * C * K)
        log(f"[10 batch] bid_topk_batched C={C} (K={K}, {B} instances): "
            f"kernel {ms:.4f} ms (back to back {ms_device:.4f}), plain "
            f"{plain_ms:.4f} ms, {bound}: {bound['bound_ms'] / ms:.1%} of "
            f"the bound ({bound['bound_ms'] / ms_device:.1%} back to back); "
            f"exact")
        res = dict(max_abs_err=_abs_err(got[1], want[1]), ms=ms,
                   ms_device=ms_device, plain_ms=plain_ms, **bound)
        if not out:
            out = res
        else:
            out.update({f"all_{k}": v for k, v in res.items()
                        if k != "bound_by"})
    return out


def _batched_k2_check(batch, dev):
    """K2 on the first round of mode='device' over a chunk of 32 instances
    (131,072 rows; as solve_ell_batched starts it: transformed costs, zero
    prices, nothing assigned, the schedule's first eps, each instance's
    bigp; every row with an entry bids, through K1's batched entry):
    against its plain version, exact, keys all zero again; timed as single
    calls (ms) and back to back (ms_device) beside its bound, its time with
    no bidder (back to back), and scatter_reduce_'s resolve.  Returns the
    kernels-line numbers."""
    B, K = CHUNK3, batch.K
    N = B * N3
    valid = batch.valid[:B]
    vmax_abs = float(np.abs(batch.vals[:B][valid]).max())
    tr = A.make_transform("min", N3, np.float32, vmax_abs)
    e0, _, _ = A.default_eps_schedule(np.float32, vmax_abs, N3, tr.scale)
    vt = tr.apply(batch.vals[:B])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    base = (np.arange(B, dtype=np.int32) * N3)[:, None, None]
    cols = t((batch.cols[:B] + base).reshape(N, K))
    vals_m = t(np.where(valid, vt, neg_sentinel_np(np.float32))
               .reshape(N, K))
    nvalid = t(batch.nvalid[:B].reshape(-1).astype(np.int32))
    inf = np.float32(np.inf)
    bigp = t(np.where(valid, vt, -inf).max(axis=(1, 2))
             - np.where(valid, vt, inf).min(axis=(1, 2)) + np.float32(1))
    eps = torch.full((B,), float(e0), dtype=torch.float32, device=dev)
    state = (torch.zeros(N, dtype=torch.float32, device=dev),
             torch.full((N,), -1, dtype=torch.int32, device=dev),
             torch.full((N,), -1, dtype=torch.int32, device=dev))
    ids = torch.where(nvalid > 0, torch.arange(N, dtype=torch.int32,
                                               device=dev), N)
    tgt, bid = bid_topk_batched(ids, cols, vals_m, nvalid, state[0],
                                state[1].clone(), state[2].clone(), eps,
                                bigp, N3)
    keys = torch.zeros(N, dtype=torch.int64, device=dev)
    fresh = lambda: [a.clone() for a in state]  # noqa: E731
    got, want = fresh(), fresh()
    out_k = commit(ids, tgt, bid, got[0], got[2], got[1], keys=keys)
    out_t = commit_plain(ids, tgt, bid, want[0], want[2], want[1])
    torch.cuda.synchronize()
    if not (all(torch.equal(a, b) for a, b in zip(out_k, out_t))
            and _same_bits(got[0], want[0]) and torch.equal(got[1], want[1])
            and torch.equal(got[2], want[2])
            and int(keys.count_nonzero()) == 0):
        raise AssertionError("commit != its plain version on the chunk's "
                             "first round")
    run = lambda p, s, o: commit(ids, tgt, bid, p, o, s,  # noqa: E731
                                 keys=keys)
    ms = _median_ms(fresh, run, 20)
    ms_device = _device_ms(fresh, run, 20)
    plain_ms = _median_ms(fresh, lambda p, s, o: commit_plain(
        ids, tgt, bid, p, o, s), 5)
    none = torch.full_like(tgt, N)
    empty_ms = _device_ms(fresh, lambda p, s, o: commit(
        ids, none, bid, p, o, s, keys=keys), 20)
    bound, lib_ms = _k2_bound(ids, tgt, bid, state[0], state[2], state[1],
                              20)
    log(f"[10 batch] commit, first round of a {B}-instance chunk (C={N}, "
        f"{int((tgt < N).sum())} bids on {torch.unique(tgt[tgt < N]).numel()}"
        f" columns, {int(out_k[2][0])} won): kernel {ms:.4f} ms (back to "
        f"back {ms_device:.4f}), plain {plain_ms:.4f} ms, {bound}: "
        f"{bound['bound_ms'] / ms:.1%} of the bound "
        f"({bound['bound_ms'] / ms_device:.1%} back to back); no bidder "
        f"{empty_ms:.4f} ms; scatter_reduce_ amax {lib_ms:.4f} ms; exact")
    return dict(max_abs_err=_abs_err(got[0], want[0]), ms=ms,
                ms_device=ms_device, plain_ms=plain_ms, ms_no_bidder=empty_ms,
                library_ms=lib_ms, **bound)


def _profile_device_chunk(sub):
    """torch.profiler (device activity) over one mode='device' call on a
    chunk of 32 config-3 instances: the device time of K1's batched entry,
    of K2 and of the torch ops, and the idle share, in all and per round.
    Returns the numbers."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, metas = auction_solve_batched(sub, mode="device", device=DEVICE)
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0)
    events = _device_events(prof)

    def device_ms(pred):
        return 1e-3 * sum(e.self_device_time_total for e in events
                          if pred(e.key))

    k1 = device_ms(lambda k: "bid_kernel<" in k and "dense" not in k)
    k2 = device_ms(lambda k: "commit_kernel<" in k or "resolve_kernel<" in k)
    busy = device_ms(lambda k: True)
    rounds = max(mt["its"] for mt in metas)
    out = dict(rounds=rounds, window_ms=window_ms, busy_ms=busy, k1_ms=k1,
               k2_ms=k2, torch_ops_ms=busy - k1 - k2,
               idle_share=1 - busy / window_ms,
               round_ms=window_ms / rounds)
    log(f"[10 batch] profiler, mode='device' on {CHUNK3} instances "
        f"({rounds} rounds): window {window_ms:.1f} ms ({window_ms / rounds:.4f}"
        f" ms a round), device busy {busy:.1f} ms: K1 {k1:.1f}, K2 "
        f"{k2:.1f}, torch ops {busy - k1 - k2:.1f} ms; idle share "
        f"{1 - busy / window_ms:.3f}")
    return out


def _solve_line(name, secs, metas, cpu_objs, launches):
    """Log one batched solve; returns max |obj - obj_cpu| / (n eps_min)."""
    its = np.array([mt["its"] for mt in metas])
    found = all(mt["soln_found"] for mt in metas)
    gaps = [abs(mt["obj"] - c) for mt, c in zip(metas, cpu_objs)]
    ratio = max(g / (N3 * mt["final_eps"]) for g, mt in zip(gaps, metas))
    extra = ""
    if "device_time" in metas[0]:
        extra = (f"device_time {metas[0]['device_time']:.3f} s, "
                 f"host_gs_time {metas[0]['host_gs_time']:.3f} s, ")
    if "host_bids" in metas[0]:
        extra += (f"host bids mean "
                  f"{np.mean([mt['host_bids'] for mt in metas]):.0f}, ")
    log(f"[10 batch] {name}: {secs:.3f} s, {len(metas) / secs:.1f} inst/s; "
        f"{extra}rounds max {its.max()} mean {its.mean():.1f}; launches "
        f"{launches}; max |obj - obj_cpu| {max(gaps)!r} = {ratio:.3g} of "
        f"n * final_eps; all found: {found}")
    if not found or ratio > 1:
        raise AssertionError(f"{name}: a solve is not within n * eps_min")
    return ratio


def _profile_chunk(batch, dev):
    """torch.profiler over one chunk's device pass (dense block built
    outside the window): DK's share of the device time, the idle share,
    and K2's device time and launches there.  Returns the numbers."""
    from torch.profiler import ProfilerActivity, profile
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    blk = DB._dense_from_ell(t(batch.cols[:CHUNK3]),
                             -t(batch.vals[:CHUNK3]),
                             t(batch.valid[:CHUNK3]), N3)
    nv = t(batch.nvalid[:CHUNK3].reshape(-1).astype(np.int32))
    vv = batch.vals[batch.valid]
    e0, e_min, theta = A.default_eps_schedule(np.float32,
                                              float(np.abs(vv).max()), N3, 1)
    bigp = float(vv.max() - vv.min()) + 1.0
    run = lambda: DB._solve_dense(blk, nv, e0, e_min, theta,  # noqa: E731
                                  A.default_max_iter(N3), bigp, 128)
    run()                                                    # warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        window_us = 1e6 * (time.perf_counter() - t0)
    events = _device_events(prof)
    busy = sum(e.self_device_time_total for e in events)
    dk = sum(e.self_device_time_total for e in events
             if "dense_bid_kernel" in e.key)
    k2_us = sum(e.self_device_time_total for e in events
                if "commit_kernel<" in e.key or "resolve_kernel<" in e.key)
    k2_launches = sum(e.count for e in events if "commit_kernel<" in e.key)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:4]
    log(f"[10 batch] profiler, chunk 0's device pass ({CHUNK3} instances, "
        f"rounds max {out[2].max()}): window {window_us / 1e3:.2f} ms, device "
        f"busy {busy / 1e3:.2f} ms, idle share {1 - busy / window_us:.3f}; "
        f"DK {dk / 1e3:.2f} ms = {dk / max(busy, 1):.3f} of the device time;"
        f" top: " + ", ".join(
            f"{e.key[:40]} {e.self_device_time_total / 1e3:.2f} ms "
            f"x{e.count}" for e in top) + f"; K2 {k2_us / 1e3:.3f} ms in "
        f"{k2_launches} launches")
    return dict(window_ms=window_us / 1e3, busy_ms=busy / 1e3,
                dk_ms=dk / 1e3, k2_ms=k2_us / 1e3, k2_launches=k2_launches)


def _batch_parity(dev):
    """CUDA against CPU, bit for bit, at B = 4, n = 256: the dense hybrid
    (sols, prices, its, phases, host bids) and the batched Jacobi solve
    (sols, prices, rounds, phases)."""
    probs = [from_coo(*make_sparse(256, 256, NNZ3, seed=200 + b,
                                   integer=False), shape=(256, 256),
                      pad_to=NNZ3 + 4) for b in range(4)]
    batch = stack_problems(probs)
    g = DB.solve_batched_dense_hybrid(batch, return_prices=True,
                                      device=DEVICE)
    c = DB.solve_batched_dense_hybrid(batch, return_prices=True,
                                      device="cpu")
    keys = ("its", "phases", "host_bids", "final_eps", "obj")
    if not (np.array_equal(g[0], c[0])
            and np.array_equal(g[2].view(np.int32), c[2].view(np.int32))
            and all(a[k] == b[k] for a, b in zip(g[1], c[1]) for k in keys)):
        raise AssertionError("dense hybrid: CUDA != CPU at B=4, n=256")
    vv = batch.vals[batch.valid]
    e0, e_min, theta = A.default_eps_schedule(np.float32,
                                              float(np.abs(vv).max()), 256, 1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa
    args = (t(batch.cols), t(-batch.vals), t(batch.valid), t(batch.nvalid),
            t(np.zeros((4, 256), np.float32)))
    rg, rc = (BT.solve_ell_batched(*[a.to(d) for a in args], e0, e_min,
                                   theta, A.default_max_iter(256))
              for d in (dev, torch.device("cpu")))
    if not (torch.equal(rg.sigma.cpu(), rc.sigma)
            and _same_bits(rg.prices.cpu(), rc.prices)
            and np.array_equal(rg.rounds, rc.rounds)
            and np.array_equal(rg.phases, rc.phases)):
        raise AssertionError("batched Jacobi: CUDA != CPU at B=4, n=256")
    log(f"[10 batch] B=4 n=256: CUDA == CPU bit for bit: dense hybrid (its "
        f"{[mt['its'] for mt in g[1]]}, phases {g[1][0]['phases']}, host "
        f"bids {[mt['host_bids'] for mt in g[1]]}) and batched Jacobi "
        f"(rounds {rg.rounds.tolist()})")


def _dense_engine():
    """AuctionSolver on a dense 4096 x 4096 matrix, mode='hybrid':
    engine='auto' takes the dense engine.  float32 costs in [1, 1000):
    cold and cached, cached == cold, |obj - scipy| <= n * final_eps.
    int32 costs in [1, 1000) (ties in every row): reported as it ends; the
    GS tail budget of 100 n + 10**6 bids runs out (the JAX reference on
    the CPU ends the same way at n = 2048 and 4096, dense_tail_budget.py),
    so only an objective it reports is held to scipy's."""
    from scipy.optimize import linear_sum_assignment
    rng = np.random.default_rng(8)
    for kind, C in (("float32", (rng.random((N3, N3)) * 999 + 1)
                     .astype(np.float32)),
                    ("int32", rng.integers(1, 1000, (N3, N3)))):
        t0 = time.perf_counter()
        solver = AuctionSolver(C, mode="hybrid", device=DEVICE)
        ingest_s = time.perf_counter() - t0
        r, c = linear_sum_assignment(C)
        want = C[r, c].astype(np.float64).sum()
        sols = []
        # the int32 case runs once: a solve that spends the budget takes ~10 s
        for name in ("cold", "cached") if kind == "float32" else ("cold",):
            t0 = time.perf_counter()
            res = solver.solve()
            secs = time.perf_counter() - t0
            mt = res["meta"]
            sols.append(res["sol"])
            gap = abs(mt["obj"] - want) if mt["soln_found"] else None
            log(f"[10 batch] AuctionSolver(dense {N3}x{N3} {kind}, mode="
                f"'hybrid') {name}: {secs:.3f} s (ingest {ingest_s:.2f} s); "
                f"engine {mt.get('engine')}, its {mt['its']}, phases "
                f"{mt['phases']}, host bids {mt['host_bids']}, device_time "
                f"{mt['device_time']:.3f} s, host_gs_time "
                f"{mt['host_gs_time']:.3f} s; soln_found {mt['soln_found']},"
                f" unassigned {mt['unassigned']}; |obj - scipy| {gap!r} "
                f"(n * final_eps {N3 * mt['final_eps']!r})")
            if mt.get("engine") != "dense" or (
                    gap is not None and gap > N3 * mt["final_eps"]):
                raise AssertionError(f"dense engine {kind} {name}: {mt}")
            if kind == "float32" and not mt["soln_found"]:
                raise AssertionError(f"dense engine float32 {name}: {mt}")
        if not all(np.array_equal(sols[0], x) for x in sols):
            raise AssertionError(f"dense engine {kind}: cached != cold")


def phase_batch():
    """Phase 10.  Returns the kernels-line numbers: DK's entry, K1's and
    K2's batched times, the device-mode profile, and the launches."""
    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    batch = config3_batch()
    dk = _dense_bid_check(batch, dev)
    k1b = _batched_k1_check(batch, dev)
    k2b = _batched_k2_check(batch, dev)
    dense_bid.launches = commit.launches = 0
    t0 = time.perf_counter()
    sols, cold = auction_solve_batched(batch, mode="hybrid", device=DEVICE)
    cold_s = time.perf_counter() - t0
    launches = {"dense_bid": dense_bid.launches, "commit": commit.launches}
    dense_bid.launches = commit.launches = 0
    t0 = time.perf_counter()
    # the second call takes the default mode: 'auto' must route to the
    # dense hybrid on the card
    sols2, warm = auction_solve_batched(batch, device=DEVICE)
    if any(mt["mode"] != "dense-hybrid" for mt in warm):
        raise AssertionError("mode='auto' did not take the dense hybrid")
    warm_s = time.perf_counter() - t0
    warm_launches = {"dense_bid": dense_bid.launches,
                     "commit": commit.launches}
    if not np.array_equal(sols, sols2):
        raise AssertionError("second hybrid call differs from the first")
    # the whole batch as one chunk: the device pass ends before the first
    # GS tail starts (no overlap), which splits the two
    dense_bid.launches = commit.launches = 0
    t0 = time.perf_counter()
    sols3, one = auction_solve_batched(batch, mode="hybrid", chunk=B3,
                                       device=DEVICE)
    one_s = time.perf_counter() - t0
    one_launches = {"dense_bid": dense_bid.launches,
                    "commit": commit.launches}
    torch.cuda.empty_cache()
    if not np.array_equal(sols, sols3):
        raise AssertionError("hybrid with one chunk differs")
    t0 = time.perf_counter()
    _, cpu = auction_solve_batched(batch, mode="cpu")
    cpu_s = time.perf_counter() - t0
    cpu_objs = [mt["obj"] for mt in cpu]
    if not all(mt["soln_found"] for mt in cpu):
        raise AssertionError("mode='cpu' found no solution")
    log(f"[10 batch] mode='cpu': {cpu_s:.3f} s, {B3 / cpu_s:.1f} inst/s; "
        f"host bids mean {np.mean([mt['its'] for mt in cpu]):.0f}")
    _solve_line("hybrid cold", cold_s, cold, cpu_objs, launches)
    _solve_line("hybrid second call (auto)", warm_s, warm, cpu_objs,
                warm_launches)
    _solve_line(f"hybrid, chunk={B3} (one pass, then the GS tails)", one_s,
                one, cpu_objs, one_launches)
    if min(launches.values()) <= 0:
        raise AssertionError(f"hybrid launches {launches}")
    sub = ELLProblem(cols=batch.cols[:CHUNK3], vals=batch.vals[:CHUNK3],
                     valid=batch.valid[:CHUNK3],
                     nvalid=batch.nvalid[:CHUNK3], n=N3, m=N3)
    bid_topk_batched.launches = commit.launches = 0
    t0 = time.perf_counter()
    _, dmetas = auction_solve_batched(sub, mode="device", device=DEVICE)
    dev_s = time.perf_counter() - t0
    k1_launches = {"bid_topk_batched": bid_topk_batched.launches,
                   "commit": commit.launches}
    _solve_line(f"mode='device' ({CHUNK3} instances)", dev_s, dmetas,
                cpu_objs[:CHUNK3], k1_launches)
    rounds = max(mt["its"] for mt in dmetas)
    if not (k1_launches["bid_topk_batched"] == k1_launches["commit"]
            == rounds > 0):
        raise AssertionError(f"device launches {k1_launches}, rounds "
                             f"{rounds}")
    prof = _profile_device_chunk(sub)
    _profile_chunk(batch, dev)
    del batch
    _batch_parity(dev)
    _dense_engine()
    log(f"[10 batch] phase 10 in {time.perf_counter() - t_phase:.1f} s")
    return dk, k1b, k2b, prof, launches, k1_launches


# ---------------------------------------------------------------------------
# Phase 11: the row-sharded Jacobi solve (parallel/) and the batch over a mesh
# ---------------------------------------------------------------------------


def _sharded_inputs(prob):
    """auction_solve_sharded's schedule for ``prob`` (min, the default
    theta, mixed tail, the global bigp) and its transformed values."""
    vals, valid = prob.vals, prob.valid
    vmax_abs = float(np.abs(vals[valid]).max())
    tr = A.make_transform("min", prob.m, vals.dtype, vmax_abs)
    theta = A.device_theta_default(prob.n)
    e0, e_min, theta_v = A.default_eps_schedule(vals.dtype, vmax_abs, prob.m,
                                                tr.scale, theta=theta)
    tv = vals[valid].astype(np.float64) * (tr.sign * tr.scale)
    return dict(vals_t=tr.apply(vals), e0=e0, e_min=e_min, theta=theta_v,
                theta_tail=3.0 if theta > 5 else 0.0,
                bigp=float(tv.max() - tv.min()) + 1.0)


def _sharded_run(prob, inp, shards, max_iter, overlapped=False):
    """sharded_solve_ell (or solve_ell_overlapped) over [cuda] * shards,
    the launch counts zeroed just before; returns (result, seconds, K1
    launches, resolve launches, fused commit launches, K2 commit
    launches)."""
    dev = torch.device(DEVICE)
    mesh = PP.make_mesh([dev] * shards)
    p0 = torch.zeros(prob.m, dtype=torch.float32)
    bid_topk.launches = resolve.launches = commit.launches = 0
    commit_keys.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if overlapped:
        res = PP.solve_ell_overlapped(
            prob.cols, inp["vals_t"], prob.valid, prob.nvalid, mesh, p0,
            inp["e0"], inp["e_min"], inp["theta"], max_iter, inp["bigp"],
            theta_tail=inp["theta_tail"])
    else:
        res = PP.sharded_solve_ell(
            prob, inp["vals_t"], mesh, p0, inp["e0"], inp["e_min"],
            inp["theta"], max_iter, inp["bigp"], prob.n,
            theta_tail=inp["theta_tail"])
    torch.cuda.synchronize()
    return (res, time.perf_counter() - t0, bid_topk.launches,
            resolve.launches, commit_keys.launches, commit.launches)


def _profile_sharded(prob, inp, shards, overlapped=False):
    """torch.profiler over SHARD_PROFILE_ROUNDS sharded (or overlapped)
    rounds: K1's, the resolve launch's, the fused commit's and the torch
    ops' device time, and the idle share."""
    from torch.profiler import ProfilerActivity, profile
    tag = "[12 overlapped]" if overlapped else "[11 sharded]"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = _sharded_run(prob, inp, shards, SHARD_PROFILE_ROUNDS,
                           overlapped)[0]
        window = 1e3 * (time.perf_counter() - t0)
    events = _device_events(prof)

    def device_ms(pred):
        return 1e-3 * sum(e.self_device_time_total for e in events
                          if pred(e.key))

    k1 = device_ms(lambda k: "bid_kernel<" in k and "dense" not in k)
    k2 = device_ms(lambda k: "resolve_kernel<" in k)
    kc = device_ms(lambda k: "commit_keys_kernel<" in k)
    busy = device_ms(lambda k: True)
    out = dict(shards=shards, rounds=res.rounds, window_ms=window,
               round_ms=window / res.rounds, k1_ms=k1, k2_resolve_ms=k2,
               commit_keys_ms=kc, torch_ops_ms=busy - k1 - k2 - kc,
               idle_share=1 - busy / window)
    log(f"{tag} profiler, {shards} shards, {res.rounds} rounds: "
        f"window {window:.1f} ms ({window / res.rounds:.3f} ms a round); "
        f"device K1 {k1:.2f} ms, K2 resolve {k2:.2f} ms, fused commit "
        f"{kc:.2f} ms, torch ops {busy - k1 - k2 - kc:.2f} ms; idle share "
        f"{1 - busy / window:.3f}")
    return out


def _sharded_headline(prob):
    """The 1M headline through sharded_solve_ell on [cuda] and [cuda] * 4,
    capped at SHARD_ROUNDS rounds, each equal to the port's solve_ell on
    the card under the same cap (sigma, prices bits, rounds, phases).
    Returns the launches (K1, K2's resolve launch) per mesh."""
    inp = _sharded_inputs(prob)
    dev = torch.device(DEVICE)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    commit.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = A.solve_ell(t(prob.cols), t(inp["vals_t"]), t(prob.valid),
                      t(prob.nvalid), torch.zeros(prob.m, device=dev),
                      inp["e0"], inp["e_min"], inp["theta"], SHARD_ROUNDS,
                      n_global=prob.n, bigp=inp["bigp"],
                      theta_tail=inp["theta_tail"])
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    log(f"[11 sharded] headline {prob.n}x{prob.m}, solve_ell on the card "
        f"(cap {SHARD_ROUNDS}): {ref_s:.3f} s, {ref.rounds} rounds "
        f"({1e3 * ref_s / ref.rounds:.3f} ms a round), {ref.phases} phases, "
        f"{ref.unassigned} unassigned; K2 launches {commit.launches}")
    launches, round_ms = {}, {}
    for shards in (1, 4):
        res, secs, k1, k2, kc, k2_commit = _sharded_run(prob, inp, shards,
                                                        SHARD_ROUNDS)
        same = (torch.equal(res.sigma, ref.sigma)
                and _same_bits(res.prices, ref.prices)
                and (res.rounds, res.phases, res.unassigned)
                == (ref.rounds, ref.phases, ref.unassigned))
        round_ms[shards] = 1e3 * secs / res.rounds
        log(f"[11 sharded] headline on {shards} shard(s): {secs:.3f} s "
            f"({round_ms[shards]:.3f} ms a round); == solve_ell (sigma, "
            f"prices bits, rounds, phases): {same}; launches K1 {k1}, K2 "
            f"resolve {k2}, fused commit {kc}, K2 commit {k2_commit}")
        if not same or not k1 == k2 == kc == shards * res.rounds or \
                k2_commit:
            raise AssertionError(f"sharded headline on {shards} shards")
        launches[f"headline_{shards}"] = dict(bid_topk=k1, commit=k2,
                                              commit_keys=kc)
    prof = _profile_sharded(prob, inp, 4)
    prof.update(solve_ell_round_ms=1e3 * ref_s / ref.rounds,
                round_ms_1=round_ms[1], round_ms_4=round_ms[4])
    return launches, prof, _resolve_timing(prob, inp)


def _resolve_timing(prob, inp, reps=20):
    """K2's resolve launch alone on the headline's first sharded round
    (every row bids on zero prices): against its plain version (exact),
    timed as in phase 3, beside its byte bound and scatter_reduce_ amax
    on the same keys (the library call)."""
    from sslap_tpu_torch.ops.commit import KEY_FLIP, _flipped_keys, \
        resolve_plain
    dev = torch.device(DEVICE)
    n, m = prob.n, prob.m
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    tgt, bid = bid_topk(ids, t(prob.cols), A.mask_vals(t(inp["vals_t"]),
                                                      t(prob.valid)),
                        t(prob.nvalid), torch.zeros(m, device=dev),
                        torch.full((n,), -1, dtype=torch.int32, device=dev),
                        torch.full((m,), -1, dtype=torch.int32, device=dev),
                        np.float32(inp["e0"]), np.float32(inp["bigp"]))
    zeros = lambda: torch.zeros(m, dtype=torch.int64, device=dev)  # noqa
    got, want = resolve(ids, tgt, bid, zeros()), \
        resolve_plain(ids, tgt, bid, zeros())
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("resolve launch != its plain version")
    flipped = _flipped_keys(bid, ids)
    idx = tgt.long()
    table = lambda: torch.full((m + 1,), KEY_FLIP, dtype=torch.int64,  # noqa
                               device=dev)
    out = dict(
        bids=int((tgt < m).sum()), max_abs_err=0.0,
        ms=_median_ms(lambda: (ids, tgt, bid, zeros()), resolve, reps),
        ms_device=_device_ms(lambda: (ids, tgt, bid, zeros()), resolve,
                             reps),
        plain_ms=_median_ms(lambda: (ids, tgt, bid, zeros()), resolve_plain,
                            reps),
        library_ms=_median_ms(lambda: (table(),),
                              lambda tb: tb.scatter_reduce_(0, idx, flipped,
                                                            "amax"), reps),
        **_bound(12 * n + 16 * m))
    log(f"[11 sharded] K2 resolve launch alone, headline's first round "
        f"(C = {n}, {out['bids']} bids): {out['ms']:.4f} ms (back to back "
        f"{out['ms_device']:.4f}), plain {out['plain_ms']:.4f} ms, "
        f"scatter_reduce_ amax {out['library_ms']:.4f} ms, bound "
        f"{out['bound_ms']:.4f} ms ({out['bound_ms'] / out['ms_device']:.1%} "
        f"back to back); exact")
    return out


def _sharded_cases():
    """Phase 11's solves against the CPU: (instance, kwargs, CPU shards).
    The SHARD_N square float32 instance, complete, and the SHARD_RECT
    int32 one capped at SHARD_RECT_ROUNDS rounds, by rows and by nnz."""
    rr, cc, vv = make_instance(SHARD_N, SHARD_N, 9, seed=5)
    n, m = SHARD_RECT
    loc, val = make_sparse(n, m, 10, seed=13, high=1000)
    rect = (loc, val, (n, m))
    return {"square_f32": ((np.stack([rr, cc], 1), vv, (SHARD_N, SHARD_N)),
                           {}, 4),
            "rect_i32": (rect, dict(max_iter=SHARD_RECT_ROUNDS), 4),
            "rect_i32_nnz": (rect, dict(max_iter=SHARD_RECT_ROUNDS,
                                        partition="nnz"), 2)}


def _meta_keys(meta):
    """The meta a card solve and its CPU mesh must share: every solve's
    counts and objective, and the sharded hybrid's round histogram, host
    bids, rebuilds and comm bytes."""
    keys = ("its", "phases", "unassigned", "final_eps", "obj", "soln_found",
            "tier_rounds", "host_bids", "ladder_rebuilds",
            "comm_bytes_total", "comm_bytes_fullwidth_equiv")
    return {k: meta[k] for k in keys if k in meta}


def sharded_cpu(path: str, kind: str = "sharded") -> None:
    """--sharded-cpu PATH: phase 11's solves on CPU meshes of 4 and 2 (the
    kernels' plain versions and the key-table combine); --overlapped-cpu
    PATH: phase 12's overlapped solve on a CPU mesh of 4;
    --sharded-hybrid-cpu PATH: phase 13's 5k sharded hybrid solves (on a
    CPU mesh of 4, and AuctionSolver with device='cpu'); saved to PATH
    (npz) for the card run to compare with."""
    out = {}
    cases = {"sharded": _sharded_cases, "overlapped": _overlapped_cases,
             "sharded_hybrid": _hybrid_cases}[kind]()
    phase = {"sharded": 11, "overlapped": 12, "sharded_hybrid": 13}[kind]
    for name, (inst, kw, shards) in cases.items():
        t0 = time.perf_counter()
        if kind == "sharded_hybrid":
            res = _hybrid_solve(inst, kw, shards, "cpu")
        else:
            loc, val, shape = inst
            solve = (PP.auction_solve_overlapped if kind == "overlapped"
                     else PP.auction_solve_sharded)
            res = solve(loc=loc, val=val, shape=shape, mesh=PP.make_mesh(
                [torch.device("cpu")] * shards), **kw)
        secs = time.perf_counter() - t0
        out[name + "_sol"] = res["sol"]
        out[name + "_prices"] = res["prices"]
        out[name + "_meta"] = np.array(json.dumps(
            dict(_meta_keys(res["meta"]), seconds=secs)))
        log(f"[{phase} cpu] {name} on {shards or 1} CPU shard(s): "
            f"{secs:.1f} s, its {res['meta']['its']}")
    np.savez(path, **out)


def _sharded_parity():
    """AuctionSolver(mode='sharded', device='cuda') on phase 11's square
    and rectangular instances (the square one also against mode='cpu':
    |obj - obj_cpu| <= n * eps_min), and the rectangle by nnz through
    auction_solve_sharded on [cuda] * 2.  Returns (the results, the
    launches)."""
    dev = torch.device(DEVICE)
    results, launches = {}, {}
    for name, ((loc, val, shape), kw, shards) in _sharded_cases().items():
        bid_topk.launches = resolve.launches = commit_keys.launches = 0
        t0 = time.perf_counter()
        if "partition" in kw:
            res = PP.auction_solve_sharded(
                loc=loc, val=val, shape=shape,
                mesh=PP.make_mesh([dev] * shards), **kw)
        else:
            res = AuctionSolver(loc=loc, val=val, shape=shape,
                                mode="sharded", device=DEVICE, **kw).solve()
        secs = time.perf_counter() - t0
        mt = res["meta"]
        round_ms = 1e3 * secs / mt["its"]
        log(f"[11 sharded] {name} {shape} {kw}: CUDA ({mt['n_shards']} "
            f"shard(s)) {secs:.3f} s, its {mt['its']} ({round_ms:.3f} ms a "
            f"round), phases {mt['phases']}, soln_found {mt['soln_found']}; "
            f"launches K1 {bid_topk.launches}, K2 resolve "
            f"{resolve.launches}, fused commit {commit_keys.launches}")
        if not bid_topk.launches == resolve.launches == \
                commit_keys.launches == mt["its"] * mt["n_shards"]:
            raise AssertionError(f"sharded {name}: launches")
        results[name] = res
        launches[name] = dict(bid_topk=bid_topk.launches,
                              commit=resolve.launches,
                              commit_keys=commit_keys.launches)
        if name == "square_f32":
            cpu = AuctionSolver(loc=loc, val=val, shape=shape, mode="cpu",
                                cardinality_check=False).solve()["meta"]
            gap = abs(mt["obj"] - cpu["obj"])
            bound = shape[0] * mt["final_eps"]
            log(f"[11 sharded] {name}: |obj - obj_cpu| {gap!r} <= n * "
                f"eps_min {bound!r}: {gap <= bound}")
            if not (mt["soln_found"] and gap <= bound):
                raise AssertionError(f"sharded {name}: objective off")
    return results, launches


def _same_as_cpu_mesh(results, cpu_out, tag="[11 sharded]") -> None:
    """The card's solves against the CPU meshes, bit for bit (sol,
    prices, its, phases, unassigned, final_eps, obj)."""
    for name, res in results.items():
        cpu_meta = json.loads(str(cpu_out[name + "_meta"]))
        mt = _meta_keys(res["meta"])
        same = (np.array_equal(res["sol"], cpu_out[name + "_sol"])
                and np.array_equal(res["prices"].view(np.int32),
                                   cpu_out[name + "_prices"].view(np.int32))
                and mt == {k: cpu_meta[k] for k in mt})
        log(f"{tag} {name}: CUDA == CPU mesh "
            f"({cpu_meta['seconds']:.1f} s) bit for bit: {same}")
        if not same:
            raise AssertionError(f"{tag} {name}: CUDA != CPU mesh")


def _batched_mesh(dev):
    """auction_solve_batched(mode='device') over a 'batch' mesh of [cuda]
    * 2 against the call without a mesh, at B = 4, n = 256 (phase 10's
    parity batch): sols and metas equal."""
    batch = stack_problems([from_coo(*make_sparse(256, 256, NNZ3,
                                                  seed=200 + b,
                                                  integer=False),
                                     shape=(256, 256), pad_to=NNZ3 + 4)
                            for b in range(4)])
    one = auction_solve_batched(batch, mode="device", device=DEVICE)
    two = auction_solve_batched(batch, mode="device",
                                mesh=PP.make_mesh([dev] * 2, "batch"))
    keys = ("its", "phases", "obj", "final_eps", "unassigned")
    same = np.array_equal(one[0], two[0]) and all(
        a[k] == b[k] for a, b in zip(one[1], two[1]) for k in keys)
    log(f"[11 sharded] batched mode='device' B=4 n=256 over a mesh of 2: == "
        f"no mesh (sols, its, phases, obj): {same}; its "
        f"{[mt['its'] for mt in two[1]]}")
    if not same:
        raise AssertionError("batched over a mesh != without a mesh")


@contextlib.contextmanager
def cpu_child(flag: str):
    """The CPU meshes of phase 11 (``--sharded-cpu``) or 12
    (``--overlapped-cpu``) in a child process on one torch thread (its
    shard threads take turns), beside the card's solves; yields (process,
    output path) and kills it if it still runs at exit."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cpu_mesh.npz")
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, OMP_NUM_THREADS="1"))
        try:
            yield child, path
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()


def _child_result(child, path, flag):
    """Wait for a CPU-mesh child; returns its npz, loaded."""
    out, _ = child.communicate(timeout=900)
    for line in out.splitlines():
        log(line)
    if child.returncode != 0:
        raise RuntimeError(f"{flag} failed ({child.returncode})")
    with np.load(path) as z:
        return dict(z)


def phases_sharded(prob):
    """Phases 11 and 12.  Their headline timings first (phase 11's, then
    phase 12's fused commit, overlapped solve and round breakdowns), then
    the CPU meshes' children start beside the card's other solves.
    Returns the kernels-line numbers: phase 11's launches, profiler split
    and resolve launch timing, and phase 12's dict."""
    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    launches, prof, res_t = _sharded_headline(prob)
    ov = _overlapped_headline(prob)
    with cpu_child("--sharded-cpu") as (child, path), \
            cpu_child("--overlapped-cpu") as (ochild, opath):
        results, solver_launches = _sharded_parity()
        launches.update(solver_launches)
        _batched_mesh(dev)
        ov_results, ov["solver_launches"] = _overlapped_parity()
        ov["two_process"] = _two_process(dev)
        t0 = time.perf_counter()
        _same_as_cpu_mesh(results, _child_result(child, path,
                                                 "--sharded-cpu"))
        t1 = time.perf_counter()
        _same_as_cpu_mesh(ov_results, _child_result(
            ochild, opath, "--overlapped-cpu"), tag="[12 overlapped]")
    log(f"[12 overlapped] phases 11-12 in {time.perf_counter() - t_phase:.1f}"
        f" s ({t1 - t0:.1f} s waiting for phase 11's CPU meshes, "
        f"{time.perf_counter() - t1:.1f} s for phase 12's)")
    return launches, prof, res_t, ov


# ---------------------------------------------------------------------------
# Phase 12: the overlapped row-sharded solve, the fused key commit, the
# round breakdown and a two-process run on the one card
# ---------------------------------------------------------------------------


MP_N = 1024                   # phase 12: the two-process run's instance
MP_ROUNDS = 500               # phase 12: the two-process headline's cap


def _commit_keys_rounds(prob, inp, dtype):
    """The fused commit's inputs on the headline: the combined key tables
    of its first two sharded rounds on one card, each with the state it
    commits onto (round 1: every row bids on zero prices; round 2: the
    rows round 1 left unassigned, with evictions).  int32: the headline's
    transformed values rounded, eps 1.  Returns [(keys, prices, owner,
    sigma)] * 2 and eps."""
    dev = torch.device(DEVICE)
    n, m = prob.n, prob.m
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    if dtype == np.float32:
        vals, eps, bigp = inp["vals_t"], np.float32(inp["e0"]), \
            np.float32(inp["bigp"])
    else:
        vals = np.rint(inp["vals_t"]).astype(np.int32)
        tv = vals[prob.valid]
        eps, bigp = np.int32(1), np.int32(tv.max() - tv.min() + 1)
    cols, nvalid = t(prob.cols), t(prob.nvalid.astype(np.int32))
    vals_m = A.mask_vals(t(vals), t(prob.valid))
    prices = torch.zeros(m, dtype=vals_m.dtype, device=dev)
    owner = torch.full((m,), -1, dtype=torch.int32, device=dev)
    sigma = torch.full((n,), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    out = []
    for _ in range(2):
        ids = torch.where((sigma < 0) & (nvalid > 0), rows, n)
        tgt, bid = bid_topk(ids, cols, vals_m, nvalid, prices, sigma, owner,
                            eps, bigp)
        keys = resolve(ids, tgt, bid,
                       torch.zeros(m, dtype=torch.int64, device=dev))
        out.append((keys.clone(), prices.clone(), owner.clone(),
                     sigma.clone()))
        commit_keys(keys, prices, owner, sigma)
    torch.cuda.synchronize()
    return out, eps


def _commit_keys_state(keys, prices, owner, sigma):
    """A fresh copy of the fused commit's arguments per call."""
    return lambda: [keys.clone(), prices.clone(), owner.clone(),
                    sigma.clone()]


def _commit_keys_profiled_ms(state, eps, reps):
    """The fused commit kernel's device time per launch, ms, from
    torch.profiler over reps calls, each right after its arguments were
    copied (in L2, as the round leaves them)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            commit_keys(*state(), eps=eps)
        torch.cuda.synchronize()
    ev = [x for x in prof.key_averages() if "commit_keys_kernel<" in x.key]
    return 1e-3 * sum(x.self_device_time_total for x in ev) / max(
        sum(x.count for x in ev), 1)


def _commit_keys_bytes(keys, prices, owner, n_local, off, eps):
    """The bytes the fused commit must move on these inputs: the keys read,
    and per column with a bid its key zeroed and (guarded: eps given) its
    price read; per accepted bid the price written, the owner read and
    written, and the sigma writes of the evicted and installed rows that
    are the shard's."""
    from sslap_tpu_torch.ops.commit import decode_keys
    best, winner = decode_keys(keys, prices.dtype)
    has = keys != 0
    acc = has & (best > A.half_neg(prices.dtype) if eps is None
                 else best >= prices + eps)
    local = lambda r: (r >= off) & (r < off + n_local)  # noqa: E731
    nk, na = int(has.sum()), int(acc.sum())
    ev = int((acc & (owner >= 0) & local(owner)).sum())
    asg = int((acc & local(winner)).sum())
    return (8 * keys.shape[0] + 8 * nk + (0 if eps is None else 4 * nk)
            + 12 * na + 4 * (ev + asg))


def _commit_keys_check(prob, inp, reps=20):
    """The fused commit (ops.commit.commit_keys) against its plain version
    on the headline's first two sharded rounds, exact (prices bits,
    owner, sigma, the keys zeroed): float32 and int32, unguarded and
    guarded (round 2 also on prices raised by 3 eps on a random half of
    the columns: stale bids, some rejected), on one shard and as shard 1
    of 4.  Times the overlapped path's first commit (round 1's keys,
    guarded, one shard, float32) as in phase 3, beside its byte bound,
    and round 2's back to back."""
    n = prob.n
    rng = np.random.default_rng(12)
    timed = {}
    for dtype in (np.float32, np.int32):
        rounds, eps = _commit_keys_rounds(prob, inp, dtype)
        for r, (keys, prices, owner, sigma) in enumerate(rounds, 1):
            cases = [("unguarded", prices, None), ("guarded", prices, eps)]
            if r == 2:
                bump = torch.from_numpy(rng.random(prob.m) < 0.5).to(
                    prices.device)
                cases.append(("stale", torch.where(
                    bump, prices + 3 * eps, prices), eps))
            for name, p, e in cases:
                for shards, part in ((1, 0), (4, 1)):
                    n_local = n // shards
                    off = part * n_local
                    state = _commit_keys_state(keys, p, owner,
                                               sigma[off:off + n_local])
                    got, want = state(), state()
                    commit_keys(*got, row_offset=off, eps=e)
                    commit_keys_plain(*want, row_offset=off, eps=e)
                    torch.cuda.synchronize()
                    if not all(_same_bits(a, b) for a, b in zip(got, want)) \
                            or bool(got[0].any()):
                        raise AssertionError(
                            f"fused commit != plain: {dtype.__name__} round "
                            f"{r} {name} shard {part} of {shards}")
                    if dtype == np.float32 and shards == 1 and \
                            (r, name) in ((1, "guarded"), (2, "unguarded")):
                        timed[r] = (state, e, _commit_keys_bytes(
                            keys, p, owner, n_local, off, e))
        log(f"[12 overlapped] fused commit == plain on the headline's "
            f"rounds 1-2, {dtype.__name__}, unguarded / guarded / stale, "
            f"1 shard and shard 1 of 4: exact")
    state, e, nbytes = timed[1]
    run = lambda k, p, o, s: commit_keys(k, p, o, s, eps=e)  # noqa: E731
    out = dict(
        max_abs_err=0.0, ms=_median_ms(state, run, reps),
        ms_device=_device_ms(state, run, reps),
        ms_profiler=_commit_keys_profiled_ms(state, e, reps),
        plain_ms=_median_ms(state, lambda k, p, o, s: commit_keys_plain(
            k, p, o, s, eps=e), reps),
        library_ms=None, **_bound(nbytes))
    state2, e2, nbytes2 = timed[2]
    out["round2_ms_device"] = _device_ms(
        state2, lambda k, p, o, s: commit_keys(k, p, o, s, eps=e2), reps)
    out["round2_ms_profiler"] = _commit_keys_profiled_ms(state2, e2, reps)
    out["round2_bound_ms"] = _bound(nbytes2)["bound_ms"]
    log(f"[12 overlapped] fused commit, headline round 1 keys, guarded: "
        f"{out['ms']:.4f} ms (back to back, each on its own cold copy "
        f"{out['ms_device']:.4f}; profiler, each after its copy, as on "
        f"the round's path, {out['ms_profiler']:.4f}), plain "
        f"{out['plain_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms "
        f"({out['bound_bytes']} bytes; "
        f"{out['bound_ms'] / out['ms_device']:.1%} back to back); round 2 "
        f"unguarded back to back {out['round2_ms_device']:.4f} ms, "
        f"profiler {out['round2_ms_profiler']:.4f} ms, bound "
        f"{out['round2_bound_ms']:.4f} ms")
    return out


def _overlapped_headline(prob):
    """Phase 12's parts on the 1M headline: the fused commit's check and
    timing, solve_ell_overlapped on [cuda] and [cuda] * 4 capped at
    SHARD_ROUNDS rounds (bit-identical: sigma, prices bits, rounds,
    phases; K1, the resolve launch and the fused commit once a shard a
    round, K2's commit launch never), the profiler over
    SHARD_PROFILE_ROUNDS rounds on four shards, and measure_round_breakdown
    on 1 and 4 shards, overlap off and on."""
    inp = _sharded_inputs(prob)
    out = {"commit_keys": _commit_keys_check(prob, inp), "launches": {}}
    runs = {}
    for shards in (1, 4):
        res, secs, k1, k2, kc, k2_commit = _sharded_run(
            prob, inp, shards, SHARD_ROUNDS, overlapped=True)
        runs[shards] = res
        out[f"round_ms_{shards}"] = 1e3 * secs / res.rounds
        log(f"[12 overlapped] headline on {shards} shard(s): {secs:.3f} s, "
            f"{res.rounds} rounds ({out[f'round_ms_{shards}']:.3f} ms a "
            f"round), {res.phases} phases, {res.unassigned} unassigned; "
            f"launches K1 {k1}, K2 resolve {k2}, fused commit {kc}, K2 "
            f"commit {k2_commit}")
        if not k1 == k2 == kc == shards * res.rounds or k2_commit:
            raise AssertionError(f"overlapped headline on {shards} shards: "
                                 f"launches")
        out["launches"][f"headline_{shards}"] = dict(
            bid_topk=k1, commit=k2, commit_keys=kc)
    a, b = runs[1], runs[4]
    same = (torch.equal(a.sigma, b.sigma) and _same_bits(a.prices, b.prices)
            and (a.rounds, a.phases, a.unassigned)
            == (b.rounds, b.phases, b.unassigned))
    log(f"[12 overlapped] headline, 1 shard == 4 shards (sigma, prices "
        f"bits, rounds, phases): {same}")
    if not same:
        raise AssertionError("overlapped headline: 1 shard != 4 shards")
    out["profile"] = _profile_sharded(prob, inp, 4, overlapped=True)
    out["two_process_headline"] = _two_process_headline(prob, inp)
    out["breakdown"] = {}
    dev = torch.device(DEVICE)
    for shards in (1, 4):
        for overlap in (False, True):
            t0 = time.perf_counter()
            br = PP.measure_round_breakdown(
                prob, PP.make_mesh([dev] * shards), overlap=overlap)
            key = f"{shards}_{'overlap' if overlap else 'plain'}"
            out["breakdown"][key] = br
            log(f"[12 overlapped] measure_round_breakdown, {shards} "
                f"shard(s), overlap={overlap} ({time.perf_counter() - t0:.1f}"
                f" s): " + ", ".join(f"{k} {v!r}" for k, v in br.items()))
            if not all(np.isfinite(br[k]) and br[k] >= 0 for k in (
                    "round_s", "compute_s", "comm_s", "comm_fraction")) \
                    or br["n_shards"] != shards:
                raise AssertionError("measure_round_breakdown")
    return out


def _overlapped_cases():
    """Phase 12's complete solve against the CPU: the SHARD_N square
    float32 instance (phase 11's), overlapped, on a CPU mesh of 4."""
    return {"overlapped_f32": _sharded_cases()["square_f32"]}


def _overlapped_parity():
    """AuctionSolver(mode='overlapped', device='cuda') on phase 11's 5k
    square float32 instance, complete: soln_found, |obj - obj_cpu| <= n *
    eps_min against mode='cpu', and K1, the resolve launch and the fused
    commit once a shard a round.  Returns (the results, the launches)."""
    results, launches = {}, {}
    for name, ((loc, val, shape), kw, _) in _overlapped_cases().items():
        bid_topk.launches = resolve.launches = commit_keys.launches = 0
        t0 = time.perf_counter()
        res = AuctionSolver(loc=loc, val=val, shape=shape, mode="overlapped",
                            device=DEVICE, **kw).solve()
        secs = time.perf_counter() - t0
        mt = res["meta"]
        cpu = AuctionSolver(loc=loc, val=val, shape=shape, mode="cpu",
                            cardinality_check=False).solve()["meta"]
        gap = abs(mt["obj"] - cpu["obj"])
        bound = shape[0] * mt["final_eps"]
        log(f"[12 overlapped] {name} {shape}: CUDA ({mt['n_shards']} "
            f"shard(s)) {secs:.3f} s, its {mt['its']} "
            f"({1e3 * secs / mt['its']:.3f} ms a round), phases "
            f"{mt['phases']}, soln_found {mt['soln_found']}; launches K1 "
            f"{bid_topk.launches}, K2 resolve {resolve.launches}, fused "
            f"commit {commit_keys.launches}; |obj - obj_cpu| {gap!r} <= n * "
            f"eps_min {bound!r}: {gap <= bound}")
        if not bid_topk.launches == resolve.launches == \
                commit_keys.launches == mt["its"] * mt["n_shards"]:
            raise AssertionError(f"overlapped {name}: launches")
        if not (mt["soln_found"] and gap <= bound):
            raise AssertionError(f"overlapped {name}: objective off")
        results[name] = res
        launches[name] = dict(bid_topk=bid_topk.launches,
                              commit=resolve.launches,
                              commit_keys=commit_keys.launches)
    return results, launches


def _launch_two_process(args, timeout=360, backend="overlapped"):
    """parallel/multiproc.py with two workers on the one card over Gloo
    (NCCL refuses two ranks on one card), a shard each, worker 0's
    solution saved; returns (report, solution, seconds with start-up)."""
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "two_process.npz")
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "sslap_tpu_torch.parallel.multiproc",
             "--backend", backend, "--nproc", "2", "--local-devices",
             "1", "--device", DEVICE, "--dist-backend", "gloo",
             "--timeout", str(timeout - 60), "--out", path, *args],
            capture_output=True, text=True, timeout=timeout, cwd=root)
        secs = time.perf_counter() - t0
        for line in run.stdout.splitlines()[-5:]:
            log("  " + line)
        if run.returncode != 0:
            log(run.stderr[-3000:])
            raise AssertionError(f"two-process run failed ({run.returncode})")
        rep = json.loads([ln for ln in run.stdout.splitlines()
                          if ln.startswith("{")][-1])
        with np.load(path) as z:
            return rep, dict(z), secs


def _two_process_headline(prob, inp):
    """The 1M headline's overlapped solve capped at MP_ROUNDS in two
    processes on the one card (multiproc --problem), a shard each, against
    the one-process solve on [cuda] * 2 run before and after it: sigma,
    prices bits, rounds, phases and unassigned equal; the solve's own time
    a round (devices synchronised around it) beside the one-process
    runs'."""
    import tempfile
    ones = []
    ones.append(_sharded_run(prob, inp, 2, MP_ROUNDS, overlapped=True))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "headline.npz")
        MP.save_problem(path, prob.cols, inp["vals_t"], prob.valid,
                        prob.nvalid, np.zeros(prob.m, np.float32), inp["e0"],
                        inp["e_min"], inp["theta"], inp["bigp"],
                        inp["theta_tail"])
        rep, got, secs = _launch_two_process(
            ["--problem", path, "--max-iter", str(MP_ROUNDS)])
    ones.append(_sharded_run(prob, inp, 2, MP_ROUNDS, overlapped=True))
    one = ones[0][0]
    same = all(np.array_equal(got["sol"], r.sigma.cpu().numpy())
               and got["prices"].tobytes() == r.prices.cpu().numpy().tobytes()
               and (int(got["its"]), int(got["phases"]),
                    int(got["unassigned"]))
               == (r.rounds, r.phases, r.unassigned) for r, *_ in ones)
    one_ms = [1e3 * o[1] / o[0].rounds for o in ones]
    log(f"[12 overlapped] headline, two processes x 1 shard on the card "
        f"(Gloo, {8 * prob.m} bytes of keys all-reduced a round), cap "
        f"{MP_ROUNDS}: solve {rep['solve_s']:.3f} s, {rep['rounds']} "
        f"rounds ({rep['ms_per_round']:.3f} ms a round; {secs:.1f} s with "
        f"start-up); one process on [cuda] * 2 before / after: "
        f"{ones[0][1]:.3f} / {ones[1][1]:.3f} s ({one_ms[0]:.3f} / "
        f"{one_ms[1]:.3f} ms a round); == one process (sigma, prices bits, "
        f"rounds, phases, unassigned): {same}")
    if not same or one.rounds != MP_ROUNDS:
        raise AssertionError("two-process headline != one process")
    return dict(rounds=rep["rounds"], solve_s=rep["solve_s"],
                ms_per_round=rep["ms_per_round"], seconds=secs,
                one_process_s=[o[1] for o in ones],
                one_process_ms_per_round=one_ms,
                key_bytes_per_round=8 * prob.m)


def _two_process(dev):
    """AuctionSolver's overlapped path end to end in two processes on the
    one card (``auction_solve_overlapped`` in each, n = MP_N, a shard
    each), against the one-process solve on [cuda] * 2: sol, prices bits,
    rounds, phases and final eps equal, and scipy's objective.  A check of
    the path, not a timing: MP_N's key table is 8 KB."""
    rep, got, secs = _launch_two_process(["--n", str(MP_N)])
    loc, val = MP.build_instance(MP_N, 8, 0)
    one = PP.auction_solve_overlapped(loc=loc, val=val, shape=(MP_N, MP_N),
                                      mesh=PP.make_mesh([dev] * 2))
    mt = one["meta"]
    same = (np.array_equal(got["sol"], one["sol"])
            and got["prices"].tobytes() == one["prices"].tobytes()
            and (int(got["its"]), int(got["phases"]),
                 float(got["final_eps"]))
            == (mt["its"], mt["phases"], mt["final_eps"]))
    log(f"[12 overlapped] two processes x 1 shard on the card (Gloo), n = "
        f"{MP_N}: {secs:.1f} s with start-up, {rep['rounds']} rounds; == one "
        f"process on [cuda] * 2 (sol, prices bits, rounds, phases, "
        f"final_eps): {same}; obj {rep['obj']!r} == scipy "
        f"{rep['scipy_obj']!r}: {rep['ok']}")
    if not (same and rep["ok"]):
        raise AssertionError("two-process overlapped run != one process")
    return dict(n=MP_N, rounds=rep["rounds"])


# ---------------------------------------------------------------------------
# Phase 13: the sharded hybrid (parallel/sharded_compact.py)
# ---------------------------------------------------------------------------


HYBRID_TRUNC = 32             # phase 13: the 5k solves' truncation


def _contested_instance(n, C, seed=0):
    """The reference's contested instance (its tests' builder, in bulk):
    rows 0..C-1 bid on a dense C x C block, so the active rows crowd into
    the first shard, whose balanced ladder buffer overflows; the other
    rows hold their diagonal alone.  Costs in [1, 100), float32."""
    val = np.random.default_rng(seed).integers(1, 100, C * C + n - C)
    loc = np.stack([np.r_[np.repeat(np.arange(C), C), np.arange(C, n)],
                    np.r_[np.tile(np.arange(C), C), np.arange(C, n)]], 1)
    return loc, val.astype(np.float32), (n, n)


def _hybrid_cases():
    """Phase 13's 5k solves against the CPU: (instance, kwargs, shards);
    shards 0 is AuctionSolver(mode='sharded_hybrid') on its device alone
    (the reference's default trunc), the others the solve on a mesh of 4
    at trunc = HYBRID_TRUNC, plain and balanced, and balanced on the
    contested instance (n = 5000, a 128-row block), where the buffers
    overflow and local rebuilds readmit the waiting rows."""
    inst, _, _ = _sharded_cases()["square_f32"]
    balanced = dict(trunc=HYBRID_TRUNC, ladder_balance=True,
                    balance_floor=16)
    return {"solver": (inst, {}, 0),
            "trunc32": (inst, dict(trunc=HYBRID_TRUNC), 4),
            "trunc32_balanced": (inst, balanced, 4),
            "contested_balanced": (_contested_instance(5000, 128), balanced,
                                   4)}


def _hybrid_solve(inst, kw, shards, device):
    loc, val, shape = inst
    if shards == 0:
        return AuctionSolver(loc=loc, val=val, shape=shape,
                             mode="sharded_hybrid", device=device).solve()
    return PP.auction_solve_sharded_hybrid(
        loc=loc, val=val, shape=shape,
        mesh=PP.make_mesh([torch.device(device)] * shards), **kw)


def _zero_counts() -> None:
    bid_topk.launches = commit.launches = 0
    resolve.launches = commit_keys.launches = 0


def _counts() -> dict:
    return dict(bid_topk=bid_topk.launches, commit=commit.launches,
                resolve=resolve.launches, commit_keys=commit_keys.launches)


def _expected_counts(meta, shards) -> dict:
    """Launches a sharded hybrid solve must make: per shard K1 once a
    round, K2's resolve launch alone and the fused commit once a
    full-width round (the fused commit also once a phase for the
    overlapped regime's drain), K2 once a compact exchange round."""
    tr = meta["tier_rounds"]
    full = tr[0] + tr[1]
    drain = meta["phases"] if meta["overlap"] else 0
    return dict(bid_topk=shards * meta["its"], commit=shards * sum(tr[2:]),
                resolve=shards * full, commit_keys=shards * (full + drain))


def _hybrid_run(prob, shards, obj_cpu, tag, **kw):
    """auction_solve_sharded_hybrid on the headline over [cuda] * shards,
    the counts zeroed just before it and read just after (its HK check
    is phase 5's); soln_found, |obj - obj_cpu| <= n * eps_min and the
    launches checked.  Returns (result, seconds, launches)."""
    mesh = PP.make_mesh([torch.device(DEVICE)] * shards)
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = PP.auction_solve_sharded_hybrid(prob, mesh=mesh,
                                          cardinality_check=False, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = _counts()
    mt = res["meta"]
    gap = abs(mt["obj"] - obj_cpu) if mt["soln_found"] else float("inf")
    bound = prob.n * mt["final_eps"]
    log(f"[13 sharded hybrid] {tag}, {shards} shard(s) {kw}: "
        f"{secs:.3f} s; device {mt['device_time']:.3f} s "
        f"({1e3 * mt['device_time'] / mt['its']:.4f} ms a round), host GS "
        f"{mt['host_gs_time']:.3f} s, host bids {mt['host_bids']}; its "
        f"{mt['its']}, phases {mt['phases']}, tier_rounds "
        f"{mt['tier_rounds']} (tiers {mt['tier_capacities'][2:]}); "
        f"comm bytes {mt['comm_bytes_total']} against "
        f"{mt['comm_bytes_fullwidth_equiv']} full width; |obj - obj_cpu| "
        f"{gap!r} <= n * eps_min {bound!r}: {gap <= bound}; launches {got}")
    if not (mt["soln_found"] and gap <= bound):
        raise AssertionError(f"sharded hybrid {tag} on {shards} shards: "
                             f"objective off")
    want = _expected_counts(mt, shards)
    if got != want or not all(got.values()):
        raise AssertionError(f"sharded hybrid {tag} on {shards} shards: "
                             f"launches {got}, want {want}")
    return res, secs, got


def _gathered_check(captured, n_glob, reps=20):
    """(a) K2 over the gathered set against its plain version, exact
    (stay, evicted, counts, prices bits, owner, the shard's sigma, the key
    table zeroed): the four-shard headline's first compact exchange round
    as shards 0 and 2 committed it (``captured``: row offset -> its
    arguments), in float32 and in int32 (bids and prices rounded).  The
    float32 shard-0 commit timed as phase 3 times K2, beside its byte
    bound and scatter_reduce_ amax of the keys."""
    offs = sorted(captured)
    out = {}
    for dtype in (torch.float32, torch.int32):
        for off in (offs[0], offs[2]):
            ids, tgt, bid, prices, owner, sigma = captured[off]
            if dtype == torch.int32:
                bid = torch.round(bid).to(torch.int32)
                prices = torch.round(prices).to(torch.int32)
            m = prices.shape[0]
            keys = torch.zeros(m, dtype=torch.int64, device=ids.device)
            state = lambda: [prices.clone(), owner.clone(),  # noqa: E731
                             sigma.clone()]
            got, want = state(), state()
            kw = dict(row_offset=off, n_rows=n_glob)
            out_k = commit(ids, tgt, bid, *got, keys, **kw)
            out_t = commit_plain(ids, tgt, bid, *want, **kw)
            torch.cuda.synchronize()
            if not (all(torch.equal(a, b) for a, b in zip(out_k, out_t))
                    and all(_same_bits(a, b) for a, b in zip(got, want))
                    and int(keys.count_nonzero()) == 0):
                raise AssertionError(f"gathered commit != plain ({dtype}, "
                                     f"row offset {off})")
            won, ev, stayed = out_k[2].tolist()
            log(f"[13 sharded hybrid] (a) K2 over the gathered set, "
                f"{ids.shape[0]} entries ({int((tgt < m).sum())} bids: "
                f"{won} won, {ev} evicted, {stayed} stayed), {dtype}, row "
                f"offset {off}: exact")
            if dtype != torch.float32 or off != offs[0]:
                continue
            run = lambda p, o, s: commit(  # noqa: E731
                ids, tgt, bid, p, o, s, keys, **kw)
            bound, lib_ms = _k2_bound(ids, tgt, bid, prices, owner, sigma,
                                      reps, **kw)
            out = dict(
                entries=int(ids.shape[0]), bids=int((tgt < m).sum()),
                won=won, max_abs_err=_abs_err(got[0], want[0]),
                ms=_median_ms(state, run, reps),
                ms_device=_device_ms(state, run, reps),
                plain_ms=_median_ms(state, lambda p, o, s: commit_plain(
                    ids, tgt, bid, p, o, s, **kw), reps),
                library_ms=lib_ms, **bound)
            log(f"[13 sharded hybrid] (a) gathered K2, float32, shard 0: "
                f"{out['ms']:.4f} ms (back to back {out['ms_device']:.4f}), "
                f"plain {out['plain_ms']:.4f} ms, scatter_reduce_ amax "
                f"{lib_ms:.4f} ms, bound {out['bound_ms']:.4f} ms "
                f"({out['bound_bytes']} bytes; "
                f"{out['bound_ms'] / out['ms_device']:.1%} back to back)")
    return out


def _hybrid_headline(prob, head5):
    """(b) the headline on [cuda] and [cuda] * 4, complete, equal bit for
    bit (sol, prices, its, phases, host bids); the four-shard run's first
    gathered commit of shards 0 and 2 kept for (a); (c) overlap=True on
    [cuda] * 4 against (b)'s rounds; a profiler window over the
    four-shard device pass's first HYBRID_PROFILE_ROUNDS rounds."""
    from sslap_tpu_torch.parallel import sharded_compact as SC
    obj_cpu = head5["obj_cpu"]
    runs, launches, captured, n_rows = {}, {}, {}, []
    real = SC.commit

    def first_commit(*a):
        # a[7], a[8]: the shard's row offset and the padded row count;
        # the arguments before the commit
        if a[7] not in captured:
            captured[a[7]] = [x.clone() for x in a[:6]]
            n_rows[:] = [a[8]]
        return real(*a)

    for shards in (1, 4):
        SC.commit = first_commit if shards == 4 else real
        try:
            runs[shards] = _hybrid_run(prob, shards, obj_cpu, "headline")
        finally:
            SC.commit = real
        launches[f"headline_{shards}"] = runs[shards][2]
    a, b = runs[1][0], runs[4][0]
    same = (np.array_equal(a["sol"], b["sol"])
            and np.array_equal(a["prices"].view(np.int32),
                               b["prices"].view(np.int32))
            and all(a["meta"][k] == b["meta"][k]
                    for k in ("its", "phases", "host_bids", "obj")))
    log(f"[13 sharded hybrid] (b) headline, 1 shard == 4 shards (sol, "
        f"prices bits, its, phases, host bids, obj): {same}; the single-"
        f"card hybrid (phase 5, cached): {head5['cached_s']:.3f} s, device "
        f"{head5['device_time']:.3f} s for {head5['its']} rounds")
    if not same:
        raise AssertionError("sharded hybrid headline: 1 shard != 4 shards")
    gathered = _gathered_check(captured, n_rows[0])
    ov, secs, launches["overlap_4"] = _hybrid_run(prob, 4, obj_cpu,
                                                  "headline", overlap=True)
    log(f"[13 sharded hybrid] (c) overlap on 4 shards: its "
        f"{ov['meta']['its']} against {b['meta']['its']} synchronous, "
        f"tier_rounds {ov['meta']['tier_rounds']} against "
        f"{b['meta']['tier_rounds']}")
    profile = _profile_hybrid(prob)
    summary = {f"{k}_{s}": runs[s][0]["meta"][k] for s in (1, 4) for k in (
        "its", "phases", "tier_rounds", "host_bids", "device_time",
        "host_gs_time", "comm_bytes_total", "comm_bytes_fullwidth_equiv")}
    summary.update({f"seconds_{s}": runs[s][1] for s in (1, 4)},
                   overlap_its=ov["meta"]["its"], overlap_seconds=secs,
                   overlap_tier_rounds=ov["meta"]["tier_rounds"],
                   overlap_device_time=ov["meta"]["device_time"],
                   hybrid_cached_s=head5["cached_s"], profile=profile)
    return launches, gathered, summary


HYBRID_PROFILE_ROUNDS = 600   # phase 13: device-pass rounds under the
                              # profiler (phase 1's full-width and
                              # compact rounds)


def _profile_hybrid(prob, shards=4):
    """torch.profiler over the sharded hybrid's device pass on the headline
    (``sharded_compact.solve_sharded_tiered`` set up by the solve's own
    ``prepare_sharded_tiered`` at its defaults, capped at
    HYBRID_PROFILE_ROUNDS rounds, no host tail) on [cuda] * shards: K1's,
    K2's (both launches, and the resolve launch alone), the fused
    commit's and the torch ops' device time, and the idle share of the
    window."""
    from torch.profiler import ProfilerActivity, profile
    from sslap_tpu_torch.parallel import sharded_compact as SC
    su = SC.prepare_sharded_tiered(prob, shards,
                                   max_iter=HYBRID_PROFILE_ROUNDS)
    mesh = PP.make_mesh([torch.device(DEVICE)] * shards)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res, tier_rounds = SC.solve_sharded_tiered(*su.args, mesh=mesh,
                                                   **su.kw)
        torch.cuda.synchronize()
        window = 1e3 * (time.perf_counter() - t0)
    events = _device_events(prof)

    def device_ms(pred):
        return 1e-3 * sum(e.self_device_time_total for e in events
                          if pred(e.key))

    k1 = device_ms(lambda k: "bid_kernel<" in k and "dense" not in k)
    k2 = device_ms(lambda k: "resolve_kernel<" in k or
                   "commit_kernel<" in k)
    kc = device_ms(lambda k: "commit_keys_kernel<" in k)
    busy = device_ms(lambda k: True)
    out = dict(shards=shards, rounds=res.rounds, tier_rounds=tier_rounds,
               window_ms=window, round_ms=window / res.rounds, k1_ms=k1,
               k2_ms=k2, commit_keys_ms=kc, torch_ops_ms=busy - k1 - k2 - kc,
               idle_share=1 - busy / window)
    log(f"[13 sharded hybrid] profiler, {shards} shards, the device pass's "
        f"first {res.rounds} rounds (tier_rounds {tier_rounds}): window "
        f"{window:.1f} ms ({out['round_ms']:.3f} ms a round); device K1 "
        f"{k1:.2f} ms, K2 {k2:.2f} ms, fused commit {kc:.2f} ms, torch ops "
        f"{out['torch_ops_ms']:.2f} ms; idle share {out['idle_share']:.3f}")
    return out


def _hybrid_parity(dev):
    """(d) the 5k solves on the card (AuctionSolver(mode='sharded_hybrid',
    device='cuda'); the solve on [cuda] * 4 at trunc = HYBRID_TRUNC, plain
    and balanced, and balanced on the contested instance, which must
    rebuild), each with its launches checked.  Returns (the results, the
    launches)."""
    results, launches = {}, {}
    for name, (inst, kw, shards) in _hybrid_cases().items():
        _zero_counts()
        t0 = time.perf_counter()
        res = _hybrid_solve(inst, kw, shards, DEVICE)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        mt = res["meta"]
        launches[name] = _counts()
        log(f"[13 sharded hybrid] (d) {name} {inst[2]} {kw}: CUDA "
            f"({mt['n_shards']} shard(s)) {secs:.3f} s, its {mt['its']}, "
            f"tier_rounds {mt['tier_rounds']}, host bids {mt['host_bids']}, "
            f"rebuilds {mt['ladder_rebuilds']}, soln_found "
            f"{mt['soln_found']}; launches {launches[name]}")
        if launches[name] != _expected_counts(mt, mt["n_shards"]) or \
                not mt["soln_found"]:
            raise AssertionError(f"sharded hybrid {name}: launches or "
                                 f"solution")
        if name == "contested_balanced" and mt["ladder_rebuilds"] < 1:
            raise AssertionError("the contested balanced run rebuilt no "
                                 "buffer")
        results[name] = res
    return results, launches


def _two_process_hybrid(dev):
    """(e) the sharded hybrid end to end in two processes on the one card
    (multiproc --backend sharded_hybrid over Gloo, a shard each, n =
    MP_N): its compact rounds all-gather across the processes, and each
    process runs the host GS tail; equal bit for bit to the one-process
    solve on [cuda] * 2 (sol, prices, its, phases, final eps, tier_rounds,
    host bids) and to scipy's objective."""
    rep, got, secs = _launch_two_process(["--n", str(MP_N)],
                                         backend="sharded_hybrid")
    loc, val = MP.build_instance(MP_N, 8, 0)
    _zero_counts()
    one = PP.auction_solve_sharded_hybrid(loc=loc, val=val,
                                          shape=(MP_N, MP_N),
                                          mesh=PP.make_mesh([dev] * 2))
    one_launches = _counts()
    mt = one["meta"]
    same = (np.array_equal(got["sol"], one["sol"])
            and got["prices"].tobytes() == one["prices"].tobytes()
            and (int(got["its"]), int(got["phases"]),
                 float(got["final_eps"]), list(got["tier_rounds"]),
                 int(got["host_bids"]))
            == (mt["its"], mt["phases"], mt["final_eps"], mt["tier_rounds"],
                mt["host_bids"]))
    log(f"[13 sharded hybrid] (e) two processes x 1 shard on the card "
        f"(Gloo), n = {MP_N}: {secs:.1f} s with start-up, solve "
        f"{rep['solve_s']:.3f} s, {rep['rounds']} rounds, tier_rounds "
        f"{rep['tier_rounds']}; == one process on [cuda] * 2 (sol, prices "
        f"bits, its, phases, final_eps, tier_rounds, host bids): {same}; "
        f"obj {rep['obj']!r} == scipy {rep['scipy_obj']!r}: {rep['ok']}; "
        f"worker 0's launches {rep['launches']}, one process's "
        f"{one_launches}")
    if not (same and rep["ok"]) or rep["launches"] != _expected_counts(
            dict(mt, its=rep["rounds"]), 1):
        raise AssertionError("two-process sharded hybrid != one process")
    return dict(n=MP_N, rounds=rep["rounds"], solve_s=rep["solve_s"],
                launches=rep["launches"], one_process_launches=one_launches)


def phase_sharded_hybrid(prob, head5):
    """Phase 13: (a)-(e) above; the CPU meshes of (d) in a child process
    (--sharded-hybrid-cpu) started at the phase's start.  Returns the
    kernels-line numbers: launches per run, (a)'s numbers and the
    headline's summary."""
    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    with cpu_child("--sharded-hybrid-cpu") as (child, path):
        launches, gathered, summary = _hybrid_headline(prob, head5)
        results, solver_launches = _hybrid_parity(dev)
        launches.update(solver_launches)
        two = _two_process_hybrid(dev)
        launches["two_process_worker0"] = two["launches"]
        t0 = time.perf_counter()
        _same_as_cpu_mesh(results, _child_result(
            child, path, "--sharded-hybrid-cpu"), tag="[13 sharded hybrid]")
    log(f"[13 sharded hybrid] phase 13 in {time.perf_counter() - t_phase:.1f}"
        f" s ({time.perf_counter() - t0:.1f} s waiting for the CPU meshes)")
    summary["two_process"] = two
    return launches, gathered, summary


# ---------------------------------------------------------------------------
# Phase 14: the candidate-list engine, calibrate, utils
# ---------------------------------------------------------------------------

CAND_N = 20_000               # phase 14(b), (f): the square instance
CAND_PROFILE_ROUNDS = 1200    # phase 14(d): device-pass rounds profiled
                              # (phase 1 and phase 2's candidate rounds)


def _cand_zero() -> None:
    _reset_ladder_counts()
    resolve.launches = commit_keys.launches = 0


@contextlib.contextmanager
def _cand_capture(n=None, tiers=()):
    """Runs of candidate.solve_candidates with their end state kept
    (``states``), and, with ``n`` and ``tiers``, K2's arguments on one
    joint set of C + resc_cap entries (a candidate round that rescans),
    from a tier below the top one where there is such a round, else from
    the top tier (``joint``)."""
    real_solve, real_commit = CD.solve_candidates, CD.commit
    states, joint = [], {}
    # a phase start's joint set has 2n entries, never one of these
    sizes = {Ct + max(min(Ct // 2, 8192), 32): Ct for Ct in tiers
             if Ct > CD.SWITCH}

    def solve(*a, **kw):
        res, st = real_solve(*a, **kw)
        states.append(st)
        return res, st

    def k2(*a):
        Ct = sizes.get(a[0].shape[0])
        if Ct is not None and (not joint or (joint["tier"] == n and
                                             Ct < n)):
            joint.update(tier=Ct, args=[x.clone() for x in a[:6]])
        return real_commit(*a)

    CD.solve_candidates, CD.commit = solve, k2
    try:
        yield states, joint
    finally:
        CD.solve_candidates, CD.commit = real_solve, real_commit


def _cand_split(tier_rounds, tiers):
    """(phase starts, candidate rounds, compact rounds) of a run."""
    cand = sum(r for r, Ct in zip(tier_rounds[1:], tiers) if Ct > CD.SWITCH)
    comp = sum(r for r, Ct in zip(tier_rounds[1:], tiers)
               if Ct <= CD.SWITCH)
    return tier_rounds[0], cand, comp


def _cand_launches(st, its, tiers, what) -> dict:
    """The launches of one candidate-engine run against its rounds: K2
    once a round (the joint commit of every phase start and candidate
    round, the commit of every compact round), K1 once a compact round,
    no ladder, no resolve launch alone, no fused commit."""
    starts, cand, comp = _cand_split(st.tier_rounds, tiers)
    got = dict(bid_topk=bid_topk.launches, commit=commit.launches,
               ladder=ladder_phase.launches, resolve=resolve.launches,
               commit_keys=commit_keys.launches)
    want = dict(bid_topk=comp, commit=its, ladder=0, resolve=0,
                commit_keys=0)
    if got != want or starts + cand + comp != its:
        raise AssertionError(f"[14 candidates] {what}: launches {got}, "
                             f"want {want} ({starts} phase starts, {cand} "
                             f"candidate and {comp} compact rounds of "
                             f"{its})")
    return dict(got, phase_starts=starts, candidate_rounds=cand,
                compact_rounds=comp)


def _cand_headline(head, head5):
    """(a) the 1M headline through AuctionSolver(mode='hybrid',
    engine='candidates', device='cuda'), complete, against phase 5's
    mode='cpu' objective, launches against rounds; one joint set of K2
    kept for (c)."""
    n = head.n
    tiers = C.default_tiers(n)
    solver = AuctionSolver(head, mode="hybrid", engine="candidates",
                           device=DEVICE)
    with _cand_capture(n, tiers) as (states, joint):
        _cand_zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver.solve()
        secs = time.perf_counter() - t0
    m, st = res["meta"], states[-1]
    gap = abs(m["obj"] - head5["obj_cpu"]) if m["soln_found"] else None
    bound = n * m["final_eps"]
    launches = _cand_launches(st, m["its"], tiers, "headline")
    log(f"[14 candidates] (a) headline, engine='candidates': {secs:.3f} s; "
        f"device {m['device_time']:.3f} s ({1e3 * m['device_time'] / m['its']:.4f}"
        f" ms/round; phase 5's compact pass {head5['device_time']:.3f} s "
        f"for {head5['its']} rounds), readback {m['readback_time']:.4f} s, "
        f"host GS {m['host_gs_time']:.3f} s ({m['host_bids']} bids); its "
        f"{m['its']}, phases {m['phases']}, rescans {st.rescans}; "
        f"tier_rounds {m['tier_rounds']} over tiers {list(tiers)}; "
        f"|obj - obj_cpu| = {gap!r} <= n * eps_min = {bound!r}")
    log(f"[14 candidates] (a) launches {launches}")
    if not (m["soln_found"] and gap <= bound):
        raise AssertionError("candidates headline: no solution within "
                             "n * eps_min of mode='cpu'")
    if not joint:
        raise AssertionError("candidates headline: no candidate round "
                             "rescanned")
    out = dict(seconds=secs, its=m["its"], phases=m["phases"],
               rescans=st.rescans, tier_rounds=m["tier_rounds"],
               device_time=m["device_time"],
               readback_time=m["readback_time"],
               host_gs_time=m["host_gs_time"], host_bids=m["host_bids"],
               obj_gap=gap, compact_device_time=head5["device_time"],
               compact_its=head5["its"], launches=launches)
    return out, joint


def _cand_joint(joint, reps=20):
    """(c) K2 over the joint set (fast and rescan bids) against its plain
    version, exact, timed as phase 3 times K2, beside its byte bound and
    scatter_reduce_ amax."""
    ids, tgt, bid, prices, owner, sigma = joint["args"]
    m = prices.shape[0]
    keys = torch.zeros(m, dtype=torch.int64, device=ids.device)
    state = lambda: [prices.clone(), owner.clone(),  # noqa: E731
                     sigma.clone()]
    got, want = state(), state()
    out_k = commit(ids, tgt, bid, *got, keys)
    out_t = commit_plain(ids, tgt, bid, *want)
    torch.cuda.synchronize()
    if not (all(torch.equal(a, b) for a, b in zip(out_k, out_t))
            and all(_same_bits(a, b) for a, b in zip(got, want))
            and int(keys.count_nonzero()) == 0):
        raise AssertionError("candidates joint commit != plain")
    won, ev, stayed = out_k[2].tolist()
    run = lambda p, o, s: commit(ids, tgt, bid, p, o, s,  # noqa: E731
                                 keys)
    bound, lib_ms = _k2_bound(ids, tgt, bid, prices, owner, sigma, reps)
    out = dict(tier=joint["tier"], entries=int(ids.shape[0]),
               bids=int((tgt < m).sum()), won=won,
               max_abs_err=_abs_err(got[0], want[0]),
               ms=_median_ms(state, run, reps),
               ms_device=_device_ms(state, run, reps),
               plain_ms=_median_ms(state, lambda p, o, s: commit_plain(
                   ids, tgt, bid, p, o, s), reps),
               library_ms=lib_ms, **bound)
    log(f"[14 candidates] (c) K2 over a joint set at tier {joint['tier']}: "
        f"{out['entries']} entries ({out['bids']} bids: {won} won, {ev} "
        f"evicted, {stayed} stayed), exact; {out['ms']:.4f} ms (back to "
        f"back {out['ms_device']:.4f}), plain {out['plain_ms']:.4f} ms, "
        f"scatter_reduce_ amax {lib_ms:.4f} ms, bound "
        f"{out['bound_ms']:.4f} ms ({out['bound_bytes']} bytes; "
        f"{out['bound_ms'] / out['ms_device']:.1%} back to back)")
    return out


def _cand_parity_solves(device):
    """(b)'s four solves on ``device``: CAND_N square (phase 4's
    instance), float32 and int32, modes 'hybrid' and 'device' with
    engine='candidates'.  Yields (name, result, end state, seconds,
    launches); the launches are checked on the card (None on the CPU)."""
    n = CAND_N
    rr, cc, vv = make_instance(n, n, 9, seed=1)
    loc = np.stack([rr, cc], 1)
    tiers = C.default_tiers(n)
    for name, val in (("float32", vv),
                      ("int32", np.round(vv).astype(np.int64))):
        for mode in ("hybrid", "device"):
            with _cand_capture() as (states, _):
                _cand_zero()
                t0 = time.perf_counter()
                res = AuctionSolver(loc=loc, val=val, shape=(n, n),
                                    mode=mode, engine="candidates",
                                    device=device).solve()
                secs = time.perf_counter() - t0
            launches = None
            if device != "cpu":
                launches = _cand_launches(states[-1], res["meta"]["its"],
                                          tiers, f"{n} {name} {mode}")
            yield f"{name}_{mode}", res, states[-1], secs, launches


_CAND_KEYS = ("its", "phases", "host_bids", "tier_rounds", "final_eps",
              "obj", "soln_found")


def candidates_cpu(path: str) -> None:
    """--candidates-cpu PATH: phase 14(b)'s solves with device='cpu' (the
    kernels' plain versions), saved to PATH (npz) for the card run to
    compare with."""
    out = {}
    for key, res, st, secs, _ in _cand_parity_solves("cpu"):
        out[key + "_sol"] = res["sol"]
        out[key + "_prices"] = res["prices"]
        out[key + "_meta"] = np.array(json.dumps(dict(
            {k: res["meta"][k] for k in _CAND_KEYS if k in res["meta"]},
            state_tier_rounds=list(st.tier_rounds), rescans=st.rescans,
            seconds=secs)))
        log(f"[14 cpu] {key}: {secs:.1f} s, its {res['meta']['its']}")
    np.savez(path, **out)


def _cand_parity(cpu):
    """(b): each card solve equal to the CPU child's (``cpu``, the npz of
    --candidates-cpu) bit for bit: sol, prices, its, phases, host bids,
    tier_rounds, final_eps, obj, rescans; the card's launches checked."""
    n = CAND_N
    out = {}
    for key, g, gs, g_s, launches in _cand_parity_solves(DEVICE):
        gm = g["meta"]
        cm = json.loads(str(cpu[key + "_meta"]))
        keys = [k for k in _CAND_KEYS[:-1] if k in gm]
        same = (np.array_equal(g["sol"], cpu[key + "_sol"])
                and np.array_equal(g["prices"].view(np.int32),
                                   cpu[key + "_prices"].view(np.int32))
                and all(gm[k] == cm[k] for k in keys)
                and list(gs.tier_rounds) == cm["state_tier_rounds"]
                and gs.rescans == cm["rescans"] and gm["soln_found"])
        name, mode = key.split("_")
        log(f"[14 candidates] (b) {n}x{n} {name} mode={mode!r}: CUDA "
            f"{g_s:.3f} s, CPU {cm['seconds']:.3f} s (a child); its "
            f"{gm['its']}, phases {gm['phases']}, rescans {gs.rescans}, "
            f"tier_rounds {gs.tier_rounds}; CUDA == CPU (sol, prices bits, "
            f"{', '.join(keys)}, rescans): {same}")
        if not same:
            raise AssertionError(f"candidates {name} {mode}: CUDA != CPU")
        out[key] = dict(cuda_s=g_s, cpu_s=cm["seconds"], its=gm["its"],
                        rescans=gs.rescans, tier_rounds=gs.tier_rounds,
                        launches=launches)
    return out


@contextlib.contextmanager
def _cand_sections():
    """The candidate engine's parts as named profiler ranges (only in
    here): the shortlist bid, the rescan (its top-k sort included), a
    compact-tier round.  The profiler ties a kernel to the torch op that
    launched it, so a range holds its torch ops' kernels, not K1's and
    K2's (launched through ctypes), which are counted by name."""
    real = {k: getattr(CD, k) for k in ("_fast_bids", "_rescan",
                                        "kernel_round")}

    def ranged(name, fn):
        def run(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return run

    for k, fn in real.items():
        setattr(CD, k, ranged("cand:" + k.strip("_"), fn))
    try:
        yield
    finally:
        for k, fn in real.items():
            setattr(CD, k, fn)


def _cand_profile(head):
    """(d) torch.profiler over the headline's candidate device pass as the
    hybrid sets it up (candidate.solve_candidates: default ladder, trunc
    256, host bigp), capped at CAND_PROFILE_ROUNDS rounds: K1's, K2's and
    the torch ops' device time, that of the torch ops by part (the
    shortlist bid, the rescan, the compact-tier rounds, the rest:
    relists, row gathers, counts), the largest kernels by name, and the
    idle share of the window."""
    from torch.profiler import ProfilerActivity, profile
    solver = AuctionSolver(head, mode="hybrid", device=DEVICE)
    inp = headline_inputs(solver)
    cols_d, vals_d, nvalid_d = inp["ell"]
    args = (cols_d, vals_d, nvalid_d,
            torch.zeros(inp["m"], device=cols_d.device), inp["e0"],
            inp["e_min"], inp["theta"], CAND_PROFILE_ROUNDS)
    kw = dict(bigp=inp["bigp"], trunc=inp["trunc"])
    CD.solve_candidates(*args, **kw)              # warm up, unprofiled
    torch.cuda.synchronize()
    with _cand_sections(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res, st = CD.solve_candidates(*args, **kw)
        torch.cuda.synchronize()
        window = 1e3 * (time.perf_counter() - t0)
    t1 = time.perf_counter()
    from torch.autograd import DeviceType
    sections = {}
    for e in prof.events():
        # the host-side range: the device time of the kernels launched in it
        if e.name.startswith("cand:") and e.device_type == DeviceType.CPU:
            sections[e.name[5:]] = sections.get(e.name[5:], 0.0) + \
                1e-3 * e.device_time_total
    events = [e for e in _device_events(prof)
              if e.self_device_time_total and not e.key.startswith("cand:")]

    def device_ms(pred):
        return 1e-3 * sum(e.self_device_time_total for e in events
                          if pred(e.key))

    k1 = device_ms(lambda k: "bid_kernel<" in k and "dense" not in k)
    k2 = device_ms(lambda k: "resolve_kernel<" in k or
                   "commit_kernel<" in k)
    busy = device_ms(lambda k: True)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    tops = [(e.key[:60], 1e-3 * e.self_device_time_total, e.count)
            for e in top]
    starts, cand, comp = _cand_split(st.tier_rounds, C.default_tiers(
        inp["n"]))
    sections["rest"] = busy - k1 - k2 - sum(sections.values())
    out = dict(rounds=res.rounds, phase_starts=starts,
               candidate_rounds=cand, compact_rounds=comp,
               rescans=st.rescans, window_ms=window,
               round_ms=window / res.rounds, busy_ms=busy, k1_ms=k1,
               k2_ms=k2, torch_ops_ms=busy - k1 - k2,
               idle_share=1 - busy / window, sections_ms=sections, top=tops,
               analysis_s=time.perf_counter() - t1)
    log(f"[14 candidates] (d) profiler, the headline's first {res.rounds} "
        f"rounds ({starts} phase starts, {cand} candidate, {comp} compact; "
        f"rescans {st.rescans}): window {window:.1f} ms "
        f"({out['round_ms']:.3f} ms a round); device busy {busy:.2f} ms: "
        f"K1 {k1:.2f} ms, K2 {k2:.2f} ms, torch ops "
        f"{out['torch_ops_ms']:.2f} ms; idle share {out['idle_share']:.3f}; "
        f"torch ops by part: " + ", ".join(f"{k} {v:.2f} ms" for k, v in
                                 sections.items()) + "; top kernels: "
        + ", ".join(f"{k} {ms:.2f} ms x{c}" for k, ms, c in tops))
    return out


def _cand_calibrate():
    """(e) calibrate's measurements on this machine, and crossover(force=
    True) with its cache in a temporary directory."""
    import tempfile
    from sslap_tpu_torch import calibrate as CAL
    t0 = time.perf_counter()
    host = CAL.measure_host_rate()
    gather = CAL.measure_gather_ns()
    real_path, real_cached = CAL._cache_path, CAL._cached
    with tempfile.TemporaryDirectory() as tmp:
        CAL._cache_path = lambda: os.path.join(tmp, "calib.json")
        try:
            cross = CAL.crossover(force=True)
            with open(CAL._cache_path()) as f:
                blob = json.load(f)
        finally:
            CAL._cache_path, CAL._cached = real_path, real_cached
    out = dict(host_bids_per_s=host, gather_ns=gather, crossover=cross,
               subprocess_gather_ns=blob["gather_ns"],
               subprocess_host_bids_per_s=blob["host_bids_per_s"],
               device_kind=blob["device_kind"],
               ref_host_bids_per_s=CAL.REF_HOST_BIDS_PER_S,
               ref_gather_ns=CAL.REF_GATHER_NS,
               seconds=time.perf_counter() - t0)
    log(f"[14 candidates] (e) calibrate: measure_host_rate {host!r} bids/s, "
        f"measure_gather_ns {gather!r} ns; crossover(force=True) {cross} "
        f"(its subprocess: {blob['device_kind']}, {blob['gather_ns']!r} ns, "
        f"host {blob['host_bids_per_s']!r} bids/s; REF "
        f"{CAL.REF_HOST_BIDS_PER_S!r} bids/s, {CAL.REF_GATHER_NS!r} ns)")
    if not (host > 0 and gather > 0 and blob["device_kind"] != "nodevice"
            and 10_000 <= cross <= 50_000_000):
        raise AssertionError("calibrate measured nothing on the card")
    return out


def _cand_trace():
    """(f) profile_trace around a cached CAND_N candidates solve: the
    Chrome trace holds the annotation and K1's and K2's kernels; and
    device_alive() answers True."""
    import tempfile
    from sslap_tpu_torch.utils import device_alive, profile_trace, \
        trace_annotation
    n = CAND_N
    rr, cc, vv = make_instance(n, n, 9, seed=1)
    solver = AuctionSolver(loc=np.stack([rr, cc], 1), val=vv, shape=(n, n),
                           mode="hybrid", engine="candidates", device=DEVICE)
    first = solver.solve()
    name = "sslap_candidates_cached_solve"
    with tempfile.TemporaryDirectory() as tmp:
        with profile_trace(tmp):
            with trace_annotation(name):
                again = solver.solve()
        files = [f for f in os.listdir(tmp) if f.endswith(".json")]
        with open(os.path.join(tmp, files[0])) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    kernels = {k: any(pat in e for e in names) for k, pat in (
        ("annotation", name), ("bid_topk", "bid_kernel<"),
        ("commit", "commit_kernel<"))}
    alive = device_alive()
    same = np.array_equal(first["sol"], again["sol"])
    log(f"[14 candidates] (f) profile_trace around a cached {n}x{n} "
        f"candidates solve: {len(names)} event names; holds {kernels}; "
        f"cached == cold: {same}; device_alive() {alive}")
    if not (all(kernels.values()) and alive and same):
        raise AssertionError("profile_trace / device_alive failed")
    return dict(trace_holds=kernels, device_alive=alive)


def phase_candidates(head, head5):
    """Phase 14: (a)-(f); returns its summary and the kernels-line
    additions of K1 and K2."""
    t0 = time.perf_counter()
    out = {}
    with cpu_child("--candidates-cpu") as (child, path):
        out["headline"], joint = _cand_headline(head, head5)
        out["joint"] = _cand_joint(joint)
        del joint
        out["profile"] = _cand_profile(head)
        out["parity"] = _cand_parity(_child_result(child, path,
                                                   "--candidates-cpu"))
    out["calibrate"] = _cand_calibrate()
    out["trace"] = _cand_trace()
    out["seconds"] = time.perf_counter() - t0
    log(f"[14 candidates] phase 14: {out['seconds']:.1f} s")
    runs = dict(headline=out["headline"]["launches"],
                **{k: v["launches"] for k, v in out["parity"].items()})
    extra = {
        "bid_topk": dict(candidates_launches={
            k: v["bid_topk"] for k, v in runs.items()}),
        "commit": dict(candidates_launches={
            k: v["commit"] for k, v in runs.items()},
            **{f"candidates_joint_{k}": v for k, v in out["joint"].items()}),
    }
    return out, extra


# ---------------------------------------------------------------------------
# Phase 15: the tracking workload (chained warm re-solves) and the examples
# ---------------------------------------------------------------------------

TRACK_FRAMES = 2              # phase 15(a): frames per family at 1M (C: 4)
TRACK_PARITY_N = 20_000       # phase 15(b): CUDA == CPU chains at this n
EX_TRACK_N = 2000             # phase 15(c): the tracking example's n


def _same_np_bits(a, b) -> bool:
    return _same_bits(torch.from_numpy(np.asarray(a)),
                      torch.from_numpy(np.asarray(b)))


def _track_zero() -> None:
    ladder_phase.launches = 0
    _zero_counts()


def _track_counts() -> dict:
    return dict(ladder=ladder_phase.launches, **_counts())


def _frame_kind(name: str) -> tuple:
    """("A", "cold") for "A0_cold_construct+hk+solve" and "A1_cold",
    ("B", "presolve") for family B's pre-solve."""
    return name[0], name.split("_")[1]


def _track_recorder(details: list, dev: bool = True):
    """run_families' on_frame hook: synchronises, reads the frame's
    launches (and, on the card, its peak and resident device memory),
    zeroes them for the next frame and keeps the detail."""
    def on_frame(d):
        if dev:
            torch.cuda.synchronize()
            d = dict(d, peak_bytes=torch.cuda.max_memory_allocated(),
                     resident_bytes=torch.cuda.memory_allocated())
            torch.cuda.reset_peak_memory_stats()
        d = dict(d, launches=_track_counts())
        _track_zero()
        details.append(d)
    return on_frame


def _check_frame_launches(d) -> None:
    """One ladder launch per phase of every solve in the frame, no
    standalone K1/K2 launch."""
    want = sum(m["phases"] for m in d["metas"])
    got = d["launches"]
    if got["ladder"] != want or any(got[k] for k in (
            "bid_topk", "commit", "resolve", "commit_keys")):
        raise AssertionError(f"[15 tracking] {d['frame']}: launches {got}, "
                             f"want {want} ladder launches and no other")


def _track_headline(n=N_HEAD):
    """(a): families A, B, C at 1M on the card; every frame soln_found,
    each warm frame's objective within n * eps_min of the same frame's
    cold objective, launches per frame.  Returns the summary."""
    details = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _track_zero()
    t0 = time.perf_counter()
    _, summary = TR.run_families(
        n=n, frames=TRACK_FRAMES, mode="hybrid", device=DEVICE, warm="fr",
        gs_engine="forward", on_frame=_track_recorder(details))
    seconds = time.perf_counter() - t0
    cold_obj = {}
    launches = {}
    for d in details:
        m = d["metas"][-1]
        rec = d["record"] or {}
        log(f"[15 tracking] {d['frame']}: {rec.get('s')} s, obj "
            f"{m['obj']!r}, soln_found {m['soln_found']}; device "
            f"{m['device_time']:.4f} s, readback {m['readback_time']:.4f} s,"
            f" host GS {m['host_gs_time']:.4f} s, host bids "
            f"{m['host_bids']}; phases {m['phases']}, its {m['its']}, "
            f"tier_rounds {m['tier_rounds']}; hk_s {d['hk_s']}, churn_s "
            f"{d['churn_s']}, fell_back {d['fell_back']}; launches "
            f"{d['launches']}; peak "
            f"{d['peak_bytes'] / 2**30:.3f} GiB, resident after "
            f"{d['resident_bytes'] / 2**30:.3f} GiB")
        if not (m["soln_found"] and rec.get("found", True)
                and rec.get("feasible", True)):
            raise AssertionError(f"[15 tracking] {d['frame']}: no solution")
        _check_frame_launches(d)
        fam, kind = _frame_kind(d["frame"])
        key = launches.setdefault(fam, {})
        key[kind] = key.get(kind, 0) + d["launches"]["ladder"]
        frame_no = d["frame"].split("_")[0]
        if kind == "cold":
            cold_obj[frame_no] = m["obj"]
        elif kind == "warm":
            gap = abs(m["obj"] - cold_obj[frame_no])
            bound = n * m["final_eps"]
            log(f"[15 tracking] {frame_no}: |obj_warm - obj_cold| = {gap!r}"
                f" <= n * eps_min = {bound!r}: {gap <= bound}")
            if gap > bound:
                raise AssertionError(f"[15 tracking] {frame_no}: warm "
                                     "objective off the cold one")
    by_family = {}
    for fam, word in (("A", "value_drift"), ("B", "pattern_drift"),
                      ("C", "persistent")):
        cold = summary[f"fps_{word}_cold"]
        warm = summary[f"fps_{word}_warm"]
        frames = [d for d in details if d["frame"][0] == fam]
        by_family[fam] = dict(
            fps_cold=cold, fps_warm=warm, warm_over_cold=warm / cold,
            peak_gib=max(d["peak_bytes"] for d in frames) / 2**30,
            warm_s=[d["record"]["s"] for d in frames
                    if d["record"] and d["frame"].endswith("_warm")],
            cold_s=[d["record"]["s"] for d in frames
                    if d["record"] and "_cold" in d["frame"]],
            warm_split={k: sum(d["metas"][-1][k] for d in frames
                               if d["frame"].endswith("_warm"))
                        for k in ("device_time", "readback_time",
                                  "host_gs_time")},
            hk_s=[d["hk_s"] for d in frames if d["hk_s"] is not None],
            churn_s=[d["churn_s"] for d in frames
                     if d["churn_s"] is not None],
            fell_back=sum(d["fell_back"] for d in frames))
        log(f"[15 tracking] family {fam}: frames/s cold {cold} warm {warm} "
            f"(warm / cold {warm / cold:.3f}); peak device memory "
            f"{by_family[fam]['peak_gib']:.3f} GiB; warm frames' device / "
            f"readback / host GS s {by_family[fam]['warm_split']}")
    log(f"[15 tracking] (a) summary {json.dumps(summary)}; {seconds:.1f} s")
    return dict(summary=summary, families=by_family, launches=launches,
                seconds=seconds)


def _track_parity(n=TRACK_PARITY_N):
    """(b): the same chains at n on the card and with device='cpu': every
    frame's record (but timers), sol, prices bits, its, phases, host bids,
    soln_found and fell_back equal."""
    runs = {}
    for device in (DEVICE, "cpu"):
        details = []
        _track_zero()
        t0 = time.perf_counter()
        TR.run_families(n=n, frames=TRACK_FRAMES, mode="hybrid",
                        device=device, warm="fr", gs_engine="forward",
                        on_frame=_track_recorder(details,
                                                 dev=device != "cpu"))
        runs[device] = (details, time.perf_counter() - t0)
    (dc, sc), (dp, sp) = runs[DEVICE], runs["cpu"]
    keys = ("its", "phases", "host_bids", "soln_found", "obj")
    same = len(dc) == len(dp) and all(
        a["frame"] == b["frame"] and a["fell_back"] == b["fell_back"]
        and np.array_equal(a["sol"], b["sol"])
        and _same_np_bits(a["prices"], b["prices"])
        and [[m[k] for k in keys] for m in a["metas"]]
        == [[m[k] for k in keys] for m in b["metas"]]
        and ({k: v for k, v in (a["record"] or {}).items()
              if k not in ("s", "hk_s")}
             == {k: v for k, v in (b["record"] or {}).items()
                 if k not in ("s", "hk_s")})
        for a, b in zip(dc, dp))
    for d in dc:
        _check_frame_launches(d)
    log(f"[15 tracking] (b) {n}x{n}, {len(dc)} frames (A, C, B): CUDA "
        f"{sc:.1f} s == CPU {sp:.1f} s (records, sol, prices bits, its, "
        f"phases, host bids, soln_found, fell_back): {same}")
    if not same:
        raise AssertionError("[15 tracking] CUDA chains != CPU chains")
    return dict(n=n, frames=len(dc), cuda_s=sc, cpu_s=sp,
                launches=sum(d["launches"]["ladder"] for d in dc))


def tracking_cpu(path: str) -> None:
    """--tracking-cpu PATH: the tracking example with device='cpu' at
    EX_TRACK_N (phase 15(c)'s reference), saved to PATH (npz)."""
    out = EXT.main(n=EX_TRACK_N, device="cpu")
    np.savez(path, cold_its_frame1=out["cold_its_frame1"],
             warm_hk_size=out["warm_hk_size"],
             **{f"{k}_{i}": np.asarray(f[k]) for i, f in
                enumerate(out["frames"]) for k in
                ("obj", "its", "phases", "sol", "prices")})


def _ex_basic():
    card = EXB.main(device=DEVICE)
    cpu = EXB.main(device="cpu")
    same = all(
        np.array_equal(card[k][2], cpu[k][2]) and card[k][:2] == cpu[k][:2]
        if k == "sparse_hybrid" else card[k] == cpu[k] for k in cpu)
    log(f"[15 tracking] (c) basic example on the card == device='cpu' "
        f"(objectives, hybrid rounds and sol, matching, infeasible): {same}")
    if not same:
        raise AssertionError("[15 tracking] basic example differs")


def _ex_tracking(child, path):
    _track_zero()
    t0 = time.perf_counter()
    card = EXT.main(n=EX_TRACK_N, device=DEVICE)
    secs = time.perf_counter() - t0
    launches = _track_counts()
    cpu = _child_result(child, path, "--tracking-cpu")
    same = all(
        np.array_equal(f["sol"], cpu[f"sol_{i}"])
        and _same_np_bits(f["prices"], cpu[f"prices_{i}"])
        and [f["obj"], f["its"], f["phases"]]
        == [float(cpu[f"obj_{i}"]), int(cpu[f"its_{i}"]),
            int(cpu[f"phases_{i}"])]
        for i, f in enumerate(card["frames"]))
    same = same and card["cold_its_frame1"] == int(cpu["cold_its_frame1"])
    fewer = card["frames"][1]["its"] < card["cold_its_frame1"]
    log(f"[15 tracking] (c) tracking example, mode='device', n = "
        f"{EX_TRACK_N}, 5 frames on the card: {secs:.2f} s, rounds "
        f"{[f['its'] for f in card['frames']]}, frame 1 cold "
        f"{card['cold_its_frame1']} (warm fewer: {fewer}); == device='cpu' "
        f"(sol, prices bits, obj, its, phases): {same}; checkpoint "
        f"{card['checkpoint_ok']}, warm HK {card['warm_hk_size']}; launches "
        f"{launches}")
    if not (same and fewer and card["checkpoint_ok"]
            and card["warm_hk_size"] == EX_TRACK_N):
        raise AssertionError("[15 tracking] tracking example failed")
    # one ladder launch per phase of the five frames and frame 1's cold
    # solve, no standalone K1/K2 launch
    want = sum(f["phases"] for f in card["frames"]) + \
        card["cold_phases_frame1"]
    if launches["ladder"] != want or any(launches[k] for k in (
            "bid_topk", "commit", "resolve", "commit_keys")):
        raise AssertionError(f"[15 tracking] tracking example launches "
                             f"{launches}, want {want} ladder launches")
    return dict(seconds=secs, launches=launches,
                rounds=[f["its"] for f in card["frames"]],
                cold_its_frame1=card["cold_its_frame1"])


def _ex_distributed():
    """The distributed example on make_mesh() (every local card) and on
    four shards of the one card, each with its asserts (sharded == single,
    overlap and ladder_balance give the hybrid's objective)."""
    out = {}
    for label, devices in (("mesh", None),
                           ("four_shards", [torch.device(DEVICE)] * 4)):
        _zero_counts()
        t0 = time.perf_counter()
        res = EXD.main(devices=devices)
        secs = time.perf_counter() - t0
        out[label] = dict(seconds=secs, launches=_counts(),
                          shards=res["shards"],
                          rounds=dict(single=res["single"][1],
                                      sharded=res["sharded"][1],
                                      hybrid=res["hybrid"][1],
                                      overlap=res["overlap"][1]))
        log(f"[15 tracking] (c) distributed example on {res['shards']} "
            f"shard(s): {secs:.1f} s, asserts passed; rounds "
            f"{out[label]['rounds']}; launches {out[label]['launches']}")
        if not all(out[label]["launches"][k] for k in (
                "bid_topk", "commit", "resolve", "commit_keys")):
            raise AssertionError("[15 tracking] distributed example made "
                                 "no launch of a kernel of its path")
    return out


def phase_tracking():
    """Phase 15: (a)-(c); returns its summary and the kernels-line
    additions of the ladder, K1, K2 and the fused commit."""
    t0 = time.perf_counter()
    out = {}
    with cpu_child("--tracking-cpu") as (child, path):
        out["headline"] = _track_headline()
        out["parity"] = _track_parity()
        _ex_basic()
        out["tracking_example"] = _ex_tracking(child, path)
    out["distributed"] = _ex_distributed()
    out["seconds"] = time.perf_counter() - t0
    log(f"[15 tracking] phase 15: {out['seconds']:.1f} s")
    dist = {k: v["launches"] for k, v in out["distributed"].items()}
    extra = {
        "ladder": dict(tracking_launches=out["headline"]["launches"],
                       tracking_parity_launches=out["parity"]["launches"],
                       tracking_example_launches=out["tracking_example"][
                           "launches"]["ladder"]),
        "bid_topk": dict(distributed_example_launches={
            k: v["bid_topk"] for k, v in dist.items()}),
        "commit": dict(distributed_example_launches={
            k: {"commit": v["commit"], "resolve": v["resolve"]}
            for k, v in dist.items()}),
        "commit_keys": dict(distributed_example_launches={
            k: v["commit_keys"] for k, v in dist.items()}),
    }
    return out, extra


def tracking_timing(label: str) -> None:
    """--tracking LABEL: phase 15 alone, printed as one line "TRACKING
    LABEL {...}" (numbers unrounded)."""
    phase_device()
    phase_build()
    out, _ = phase_tracking()
    print("TRACKING", label, json.dumps(
        {"tree": os.path.dirname(os.path.abspath(__file__)), **out}),
        flush=True)


def main() -> None:
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    errs, times = phase_kernels()
    solver, loc, vv = headline_solver()
    inp = headline_inputs(solver)
    ladder = phase_ladder(inp)
    phase_parity()
    launches, cold_its, head5 = phase_headline(solver, loc, vv, inp)
    head = solver.problem_spec
    del solver
    k3 = phase_gs(inp, cold_its)
    del inp
    launches.update(phase_rect())
    phase_jacobi()
    probes = phase_probes()
    dk, k1b, k2b, prof, hy_launches, dev_launches = phase_batch()
    sh_launches, sh_prof, sh_resolve, ov = phases_sharded(head)
    hy_runs, gathered, hy_summary = phase_sharded_hybrid(head, head5)
    cand, cand_extra = phase_candidates(head, head5)
    del head
    track, track_extra = phase_tracking()
    # the batched paths of K1 (mode='device') and K2 (both batched modes),
    # and each one's device time in one mode='device' call (profiler)
    # and the sharded and overlapped paths' launches (phases 11 and 12: K1,
    # and K2's resolve launch alone), with the profiler split of 4 shards
    # on the headline, and the sharded hybrid's (phase 13: K1, K2 over
    # the gathered sets and its resolve launch alone), with (a)'s numbers
    ov_launches = dict(ov["launches"], **ov["solver_launches"])
    batched = {
        "bid_topk": dict(batched_launches=dev_launches["bid_topk_batched"],
                         batched_device_mode_ms=prof["k1_ms"],
                         **{f"batched_{k}": v for k, v in k1b.items()},
                         sharded_launches={k: v["bid_topk"] for k, v in
                                           sh_launches.items()},
                         overlapped_launches={k: v["bid_topk"] for k, v in
                                              ov_launches.items()},
                         sharded_hybrid_launches={
                             k: v["bid_topk"] for k, v in hy_runs.items()},
                         sharded_profile=sh_prof),
        "commit": dict(batched_launches={
            "hybrid": hy_launches["commit"],
            "device": dev_launches["commit"]},
            batched_device_mode_ms=prof["k2_ms"],
            **{f"batched_{k}": v for k, v in k2b.items()},
            sharded_launches={k: v["commit"] for k, v in
                              sh_launches.items()},
            overlapped_launches={k: v["commit"] for k, v in
                                 ov_launches.items()},
            sharded_hybrid_launches={
                k: {"commit": v["commit"], "resolve": v["resolve"]}
                for k, v in hy_runs.items()},
            **{f"gathered_{k}": v for k, v in gathered.items()},
            sharded_resolve=sh_resolve),
    }
    kernels = []
    for name in ("bid_topk", "commit"):
        kernels.append(dict(
            name=name, **KERNELS[name], launches=launches[name],
            max_abs_err=errs[name], ms=times[name],
            ms_device=times[name + "_device"],
            plain_ms=times[name + "_plain"], **times["bounds"][name],
            library_ms=times["library"][name], **times["limiters"][name],
            **batched[name], **cand_extra[name], **track_extra[name]))
    name = "gs_auction_device"
    kernels.append(dict(
        name=name, **KERNELS[name], launches=k3["launches"],
        max_abs_err=k3["max_abs_err"], ms=k3["ms"], plain_ms=k3["plain_ms"],
        **k3["bound"], library_ms=None,
        **{key: k3[key] for key in (
            "ms_noprefetch", "tail_us_per_bid", "whole_tail_us_per_bid",
            "bid_warps", "counters")}))
    kernels.append(dict(name="ladder", **KERNELS["ladder"],
                        launches=launches["ladder"], **ladder,
                        **track_extra["ladder"]))
    # DK at C = all rows of a chunk (the first round), and at C = 256
    big, small = dk[CHUNK3 * N3], dk[min(dk)]
    kernels.append(dict(name="dense_bid", **KERNELS["dense_bid"],
                        launches=hy_launches["dense_bid"], **big,
                        library_ms=None,
                        **{f"{k}_c256": small[k] for k in
                           ("max_abs_err", "ms", "plain_ms", "bound_ms")}))
    # the fused key commit: launches on phase 12's overlapped headline
    # runs (its main path), those of phase 11's sharded runs beside
    kc = ov["commit_keys"]
    kernels.append(dict(
        name="commit_keys", **KERNELS["commit_keys"],
        launches=sum(v["commit_keys"] for v in ov["launches"].values()),
        **kc, overlapped_launches={k: v["commit_keys"] for k, v in
                                   ov_launches.items()},
        sharded_launches={k: v["commit_keys"] for k, v in
                          sh_launches.items()},
        overlapped_profile=ov["profile"], breakdown=ov["breakdown"],
        two_process=ov["two_process"],
        two_process_headline=ov["two_process_headline"],
        overlapped_round_ms={s: ov[f"round_ms_{s}"] for s in (1, 4)},
        sharded_hybrid_launches={k: hy_runs[k]["commit_keys"] for k in
                                 ("headline_1", "headline_4")},
        sharded_hybrid=hy_summary, **track_extra["commit_keys"]))
    log(f"[chip_smoke] whole run {time.perf_counter() - t_start:.1f} s "
        f"(phase 14: {cand['seconds']:.1f} s, phase 15: "
        f"{track['seconds']:.1f} s) of the 1200 s limit")
    print(json.dumps({"kernels": kernels + probes}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def k12(label: str) -> None:
    """--k12 LABEL: the K1 and K2 measurements of phases 3 and 10 alone,
    each kernel checked against its plain version on the way, printed as
    one line "K12 LABEL {...}" (ms unrounded)."""
    phase_device()
    phase_build()
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(0)
    st = _inputs(rng, N_HEAD, N_HEAD, K_HEAD, np.float32, dev)
    ids = _ids(rng, st, N_HEAD, dev)
    keys = torch.zeros(N_HEAD, dtype=torch.int64, device=dev)
    _, t, _, _ = _check_pair(st, ids, True, 20, keys)
    k1, k2, lib_ms = _k12_bounds(st, ids, 20)
    lim = _limiters(st, ids, 20, keys)
    out = {"tree": os.path.dirname(os.path.abspath(__file__)),
           "bid_topk": dict(ms=t["bid_topk"], ms_device=t["bid_topk_device"],
                            **k1, **lim["bid_topk"]),
           "commit": dict(ms=t["commit"], ms_device=t["commit_device"],
                          library_ms=lib_ms, **k2, **lim["commit"])}
    del st, ids, keys
    batch = config3_batch()
    out["bid_topk_batched"] = _batched_k1_check(batch, dev)
    out["commit_chunk"] = _batched_k2_check(batch, dev)
    out["hybrid_chunk_profile"] = _profile_chunk(batch, dev)
    sub = ELLProblem(cols=batch.cols[:CHUNK3], vals=batch.vals[:CHUNK3],
                     valid=batch.valid[:CHUNK3],
                     nvalid=batch.nvalid[:CHUNK3], n=N3, m=N3)
    del batch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, metas = auction_solve_batched(sub, mode="device", device=DEVICE)
    out["device_mode_s"] = time.perf_counter() - t0
    its = [mt["its"] for mt in metas]
    out["device_mode_rounds"] = [max(its), float(np.mean(its))]
    out["device_mode_objs"] = [mt["obj"] for mt in metas]
    out["device_mode_profile"] = _profile_device_chunk(sub)
    print("K12", label, json.dumps(out), flush=True)


def k3(label: str) -> None:
    """--k3 LABEL: phase 6's K3 measurements alone on the headline's tail
    (the twin over the first GS_TWIN_BIDS bids, then the whole tail against
    the native forward GS, prefetch on and off), printed as one line "K3
    LABEL {...}" (numbers unrounded)."""
    phase_device()
    phase_build()
    solver, _, _ = headline_solver()
    inp = headline_inputs(solver)
    del solver
    out = phase_gs(inp, stubs=False, sweep=K3_SWEEP)
    print("K3", label, json.dumps(
        {"tree": os.path.dirname(os.path.abspath(__file__)), **out}),
        flush=True)


def commit_keys_timing(label: str) -> None:
    """--commit-keys LABEL: phase 12's fused commit check and timings
    alone (the headline's first two sharded rounds), printed as one line
    "COMMIT_KEYS LABEL {...}" (numbers unrounded)."""
    phase_device()
    phase_build()
    solver, _, _ = headline_solver()
    head = solver.problem_spec
    del solver
    print("COMMIT_KEYS", label, json.dumps(
        {"tree": os.path.dirname(os.path.abspath(__file__)),
         **_commit_keys_check(head, _sharded_inputs(head))}), flush=True)


def sharded_hybrid_timing(label: str) -> None:
    """--sharded-hybrid LABEL: phase 13 alone (with the single-card
    hybrid's cached solve and the mode='cpu' objective it is held to,
    as phase 5 gives them), printed as one line "SHARDED_HYBRID LABEL
    {...}" (numbers unrounded)."""
    phase_device()
    phase_build()
    solver, loc, vv = headline_solver()
    n = solver.problem_spec.n
    solver.solve()
    t0 = time.perf_counter()
    warm = solver.solve()
    cached_s = time.perf_counter() - t0
    cpu = AuctionSolver(loc=loc, val=vv, shape=(n, n), mode="cpu",
                        cardinality_check=False).solve()
    head5 = dict(obj_cpu=cpu["meta"]["obj"], cached_s=cached_s,
                 device_time=warm["meta"]["device_time"],
                 its=warm["meta"]["its"])
    head = solver.problem_spec
    del solver
    launches, gathered, summary = phase_sharded_hybrid(head, head5)
    print("SHARDED_HYBRID", label, json.dumps(
        {"tree": os.path.dirname(os.path.abspath(__file__)),
         "launches": launches, "gathered": gathered, **summary}),
        flush=True)


def candidates_timing(label: str) -> None:
    """--candidates LABEL: phase 14 alone (with the single-card hybrid's
    cached solve and the mode='cpu' objective it is held to, as phase 5
    gives them), printed as one line "CANDIDATES LABEL {...}" (numbers
    unrounded)."""
    phase_device()
    phase_build()
    solver, loc, vv = headline_solver()
    n = solver.problem_spec.n
    solver.solve()
    warm = solver.solve()
    cpu = AuctionSolver(loc=loc, val=vv, shape=(n, n), mode="cpu",
                        cardinality_check=False).solve()
    head5 = dict(obj_cpu=cpu["meta"]["obj"],
                 device_time=warm["meta"]["device_time"],
                 its=warm["meta"]["its"])
    head = solver.problem_spec
    del solver
    out, _ = phase_candidates(head, head5)
    print("CANDIDATES", label, json.dumps(
        {"tree": os.path.dirname(os.path.abspath(__file__)), **out}),
        flush=True)


def probes(label: str) -> None:
    """--probes LABEL: phase 9's timings alone
    (probe_timings), each kernel checked on the way, printed as one line
    "PROBES LABEL {...}" (numbers unrounded)."""
    phase_device()
    phase_build()
    print("PROBES", label, json.dumps(
        {"tree": os.path.dirname(os.path.abspath(__file__)),
         **probe_timings()}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--probes":
        probes(sys.argv[2] if len(sys.argv) > 2 else "tree")
    elif len(sys.argv) > 1 and sys.argv[1] == "--k12":
        k12(sys.argv[2] if len(sys.argv) > 2 else "tree")
    elif len(sys.argv) > 1 and sys.argv[1] == "--k3":
        k3(sys.argv[2] if len(sys.argv) > 2 else "tree")
    elif len(sys.argv) > 1 and sys.argv[1] == "--sharded-hybrid":
        sharded_hybrid_timing(sys.argv[2] if len(sys.argv) > 2 else "tree")
    elif len(sys.argv) > 1 and sys.argv[1] == "--candidates":
        candidates_timing(sys.argv[2] if len(sys.argv) > 2 else "tree")
    elif len(sys.argv) > 1 and sys.argv[1] == "--tracking":
        tracking_timing(sys.argv[2] if len(sys.argv) > 2 else "tree")
    elif len(sys.argv) > 2 and sys.argv[1] == "--tracking-cpu":
        tracking_cpu(sys.argv[2])
    elif len(sys.argv) > 2 and sys.argv[1] == "--candidates-cpu":
        candidates_cpu(sys.argv[2])
    elif len(sys.argv) > 1 and sys.argv[1] == "--commit-keys":
        commit_keys_timing(sys.argv[2] if len(sys.argv) > 2 else "tree")
    elif len(sys.argv) > 2 and sys.argv[1] == "--sharded-cpu":
        sharded_cpu(sys.argv[2])
    elif len(sys.argv) > 2 and sys.argv[1] == "--overlapped-cpu":
        sharded_cpu(sys.argv[2], "overlapped")
    elif len(sys.argv) > 2 and sys.argv[1] == "--sharded-hybrid-cpu":
        sharded_cpu(sys.argv[2], "sharded_hybrid")
    else:
        main()
