"""Readings from which the limits of ``correct`` are set: the numbers
the check compares, for sound runs of the program over many seeds and for
its control (the program handed the costs rounded to bfloat16, the
precision below the configuration's float32), in one process.

    python3 lapbench/limits.py --workload CELL --seeds 1,2,... \\
        --control-seeds 7,8,9 [--requests R]

Each seed's set-up is the cell's own, at its own size; R requests (the
warm-up and R - 1 more, or R frames of a chain) are judged as a run
judges its window.  One JSON line per seed: ``{"seed", "control",
"numbers"}``, then the largest sound reading and the smallest control
reading of each number.  The benchmark's own runs do not run this."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from lapbench import harness  # noqa: E402
from lapbench.drivers import Driver, Spans  # noqa: E402


def readings(workload: str, seed: int, control: bool, requests: int,
             device: str = "cuda", overrides=None) -> dict:
    """The numbers compared for ``requests`` requests of one seed."""
    spec = harness.load_cell(workload)
    config = dict(spec["config"], **(overrides or {}))
    driver = Driver(config, spec["traffic"], seed, device=device,
                    control=control, chips=spec["cell"]["chips"])
    spans = Spans()
    records = [driver.request(k, spans) for k in range(requests)]
    checks = harness.check(driver, records, config["limits"], device)
    del driver
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {k: v["value"] for k, v in checks.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--requests", type=int, default=2)
    args = ap.parse_args(argv)
    sound, ctrl = {}, {}
    for control, seeds, acc in ((False, args.seeds, sound),
                                (True, args.control_seeds, ctrl)):
        for s in filter(None, seeds.split(",")):
            nums = readings(args.workload, int(s), control, args.requests)
            print(json.dumps({"seed": int(s), "control": control,
                              "numbers": nums}), flush=True)
            for k, v in nums.items():
                acc[k] = (max if not control else min)(acc.get(k, v), v)
    print(json.dumps({"workload": args.workload, "sound_max": sound,
                      "control_min": ctrl}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
