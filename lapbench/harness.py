"""The benchmark's harness: one run of one cell.

``run.py`` checks for the cards and calls :func:`main`; the tests call
:func:`run_cell` on the CPU.  A run: set-up (inputs from the seed, one
warm-up request), a window of whole requests for ``--seconds`` (under
``torch.profiler`` with ``--trace 1``), the peak device memory, the
check of every answer of the window against the plain reference
(``reference.py``), the cell's metrics (``--trace 0``: its end-to-end
metrics, ``--trace 1``: its per-layer metrics), and one JSON line.
Configurations, traffic mixes and metric readers are files found by the
names in ``BENCHMARK.json``; ``drivers.py`` puts a cell together from the
entry, generator and pattern modules that they name.
"""

from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from lapbench import reference, yardstick
from lapbench.drivers import Driver, Spans

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sslap_tpu")
BF_ITERS = 1000     # Bellman-Ford sweeps of the reference's own duals


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is the
    JAX stack's or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_bench(path: Path = ROOT / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[dict] = None) -> dict:
    """The workload entry, its configuration file, its traffic file and
    the metrics it reports (end to end and per layer)."""
    bench = bench or load_bench()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{', '.join(sorted(cells))}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench.get("per_layer", [])
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": e2e, "per_layer": per_layer}


def reader(name: str) -> Callable:
    """``metrics/<name>.py``'s ``read``, or that of the part of the name
    before its first dot (``ingest_s.solve`` -> ``metrics/ingest_s.py``)."""
    for stem in (name, name.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"lapbench_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r}")


class Run:
    """What a run measured, as the metric readers see it."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def window_records(self) -> List[dict]:
        return [r for r in self.records if r["req"] >= 0]

    def window_spans(self, name: str) -> List[dict]:
        return [s for s in self.spans if s["name"] == name and s["req"] >= 0]

    def per_request_s(self) -> Optional[float]:
        """The whole window over the requests completed in it."""
        return self.elapsed_s / self.requests if self.requests else None

    def mean_span_s(self, name: str) -> Optional[float]:
        sp = self.window_spans(name)
        return sum(s["t1"] - s["t0"] for s in sp) / len(sp) if sp else None

    def mean_meta(self, key: str) -> Optional[float]:
        """Mean per request of a meta timer (a batch's timers are batch
        totals, the same in each instance's meta)."""
        vals = [r["meta"][0][key] for r in self.window_records()
                if key in r["meta"][0]]
        return sum(vals) / len(vals) if vals else None


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().replace("\n", "; ") or None


def check(driver: Driver, records: List[dict], limits: Dict[str, float],
          device: str) -> Dict[str, dict]:
    """Judge every answer of the window against the plain reference;
    each number compared, with its limit."""
    insts: Dict[int, reference.Instance] = {}
    numbers: Dict[str, list] = {}
    not_found = 0
    for rec in records:
        idx = rec["inst"]
        if idx not in insts:
            item = driver.pool[idx]
            insts[idx] = reference.Instance(
                [loc[:, 0] for loc in item["loc"]],
                [loc[:, 1] for loc in item["loc"]], item["vals"],
                driver.n, driver.m, device=device)
        got = reference.judge(insts[idx], rec["sigma"], rec["obj"],
                              rec["prices"], BF_ITERS,
                              [mt.get("final_eps") for mt in rec["meta"]])
        for k, v in got.items():
            numbers.setdefault(k, []).extend(v)
        not_found += sum(not f for f in rec["found"])
    worst = reference.worst(numbers)
    worst["not_found"] = not_found
    unread = set(limits) - set(worst)
    if unread:
        raise ValueError("limits for numbers this cell's answers do not "
                         f"give: {', '.join(sorted(unread))}")
    out = {}
    for name, limit in limits.items():
        v = worst[name]
        out[name] = {"value": v, "limit": limit,
                     "ok": bool(v <= limit) and not math.isnan(v)}
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             overrides: Optional[dict] = None, control: bool = False,
             bench: Optional[dict] = None) -> dict:
    """One run of ``workload``; returns the result line's object (without
    the chip look, which :func:`main` makes).  ``overrides`` replace keys
    of the configuration (the tests' small sizes); ``control`` hands the
    program bfloat16-rounded costs (the control of ``correct``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_cell(workload, bench)
    config = dict(spec["config"], **(overrides or {}))
    cell = spec["cell"]
    cuda = torch.device(device).type == "cuda"
    devices = list(range(int(cell["chips"]))) if cuda else []
    spans = Spans(annotate=bool(trace))
    driver = Driver(config, spec["traffic"], seed, device=device,
                    control=control, chips=cell["chips"])
    records = [driver.request(-1, spans)]            # warm-up
    if cuda:
        for d in devices:
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
    setup_s = time.perf_counter() - t_start
    log(f"lapbench: {workload} seed {seed}: set-up {setup_s:.3f} s")

    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    failed, k = 0, 0
    win = torch.profiler.record_function("lapbench/window") if trace \
        else None
    if win is not None:
        win.__enter__()
    t0 = time.perf_counter()
    while True:
        try:
            records.append(driver.request(k, spans))
            log(f"lapbench: request {k}: "
                f"{spans.items[-1]['t1'] - spans.items[-2]['t0']:.4f} s")
        except Exception:                      # a request that never came
            failed += 1
            log(f"lapbench: request {k} raised:\n{traceback.format_exc()}")
        k += 1
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    if win is not None:
        win.__exit__(None, None, None)
    reduced = None
    if prof is not None:
        prof.__exit__(None, None, None)
        events, notes = yardstick.profiler_events(prof)
        del prof
        tspans, window = yardstick.spans_from_notes(notes)
        if cuda and window is not None:
            reduced = yardstick.reduce_trace(events, tspans, window, devices)
        del events

    mem_peak = max((torch.cuda.max_memory_allocated(d) for d in devices),
                   default=0)
    if cuda:
        torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)

    window_recs = [r for r in records if r["req"] >= 0]
    t_check = time.perf_counter()
    checks = check(driver, window_recs, config["limits"], device) \
        if window_recs else {}
    log(f"lapbench: {len(window_recs)} answers judged in "
        f"{time.perf_counter() - t_check:.3f} s")
    correct = (failed == 0 and bool(window_recs)
               and all(c["ok"] for c in checks.values()))
    nnz = [sum(driver.nnz(r["inst"])) for r in window_recs]
    run = Run(setup_s=setup_s, elapsed_s=elapsed, requests=len(window_recs),
              attempted=k, instances=driver.instances, records=records,
              spans=spans.items, trace=reduced, config=config,
              traffic=spec["traffic"], n=driver.n, m=driver.m,
              nnz_per_request=nnz,
              kind=torch.cuda.get_device_name(0) if cuda else "cpu")
    metrics = {}
    for m in (spec["per_layer"] if trace else spec["end_to_end"]):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": run.kind,
           "count": len(devices) if cuda else 1,
           "memory_peak_bytes": int(mem_peak)}
    if trace:
        dev["busy_s"] = reduced["busy_s"] if reduced else 0.0
        dev["window_s"] = reduced["window_s"] if reduced else elapsed
    result = {"correct": correct, "attempted": k, "failed": failed,
              "metrics": metrics, "device": dev}
    if reduced:
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    if cuda:
        result["power_limit"] = _power_limit()
    result["checks"] = {n: {"value": c["value"], "limit": c["limit"]}
                        for n, c in checks.items()}
    return result


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__("modules of the JAX stack or the JAX package were "
                         f"loaded: {', '.join(names)}")
        self.names = names


def emit(result: dict) -> None:
    """The result line on standard output; the numbers compared, each
    beside its limit, as the last lines of standard error."""
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from sslap_tpu_torch.hybrid import native_available
    spec = load_cell(args.workload)
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"lapbench: the cell needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " found")
        return 3
    if not native_available():
        log("lapbench: the program's native runtime did not load")
        return 3
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", t_start)
    except ForbiddenModules as e:
        log(f"lapbench: {e}")
        return 4
    found = forbidden_modules()
    if found:
        log(f"lapbench: {ForbiddenModules(found)}")
        return 4
    emit(result)
    return 0
