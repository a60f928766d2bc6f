"""prep_s: the host work of ``solve()`` outside the device pass, its read
back and the GS tail (the Hopcroft-Karp pre-check, the transform, CSR and
CSC, the FR sweeps of a warm start, the objective): ``solve()``'s wall
time on the harness's clock minus whichever of the program's meta timers
``device_time``, ``readback_time`` and ``host_gs_time`` it reports, mean
per request of the traced window."""

TIMERS = ("device_time", "readback_time", "host_gs_time")


def read(run):
    walls = {s["req"]: s["t1"] - s["t0"] for s in run.window_spans("solve")}
    vals = [walls[r["req"]] - sum(r["meta"][0].get(t, 0.0) for t in TIMERS)
            for r in run.window_records() if r["req"] in walls]
    return sum(vals) / len(vals) if vals else None
