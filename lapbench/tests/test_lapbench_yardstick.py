"""The byte count of the device-pass roofline and the reduction of a
profiler window, on synthetic events."""

import pytest

from lapbench import gen, yardstick


def test_pass_bytes_of_the_headline_instance():
    """bench.make_instance(1M, 1M, 9, seed=0): 9,999,949 entries of 8
    bytes, and 16 bytes a row and column of vectors."""
    n = 1_000_000
    assert yardstick.pass_bytes(n, n, 9_999_949) == 79_999_592 + 16 * n


def test_pass_bytes_from_generated_shapes():
    rr, cc, vv = gen.make_instance(1000, 1000, 9, seed=0)
    b = yardstick.pass_bytes(1000, 1000, rr.shape[0])
    assert b == 8 * rr.shape[0] + 16_000
    # a batch counts every instance's vectors
    assert yardstick.pass_bytes(4096, 4096, 10, instances=256) == \
        80 + 256 * 16 * 4096


def test_union_gaps_and_cover():
    m = yardstick.union([(5, 7), (0, 2), (1, 3), (7, 8)])
    assert m == [(0, 3), (5, 8)]
    assert yardstick.covered(m, 0, 10) == 6
    assert yardstick.gaps(m, 0, 10) == [(3, 5), (8, 10)]
    assert yardstick.gaps(m, 1, 6) == [(3, 5)]


def _events():
    # two requests: ingest [0, 10), solve [10, 50) with device work at
    # [20, 22) and [30, 35); ingest [50, 60), solve [60, 100) with device
    # work at [70, 80) on card 0 and [72, 90) on card 1
    ev = lambda d, a, b, name="k", copy=False: {  # noqa: E731
        "dev": d, "name": name, "t0": a, "t1": b, "copy": copy}
    events = [ev(0, 20, 22, "Memcpy HtoD", True), ev(0, 30, 35),
              ev(0, 70, 80), ev(1, 72, 90, "other")]
    spans = [{"name": "ingest", "req": 0, "t0": 0, "t1": 10},
             {"name": "solve", "req": 0, "t0": 10, "t1": 50},
             {"name": "ingest", "req": 1, "t0": 50, "t1": 60},
             {"name": "solve", "req": 1, "t0": 60, "t1": 100}]
    return events, spans


def test_reduce_trace_busy_idle_and_kernels():
    events, spans = _events()
    r = yardstick.reduce_trace(events, spans, (0, 100), [0, 1])
    assert r["window_s"] == pytest.approx(100e-9)
    # card 0 busy 2 + 5 + 10 = 17 ns, card 1 18 ns
    assert r["busy_s"] == pytest.approx(17.5e-9)
    assert r["idle_pct"] == pytest.approx(100 - 17.5)
    assert r["kernel_s_total"] == pytest.approx((5 + 10 + 18) * 1e-9)
    assert r["device_ops"][0] == ["other", pytest.approx(18e-9)]


def test_idle_gaps_are_cut_at_host_phases():
    events, spans = _events()
    r = yardstick.reduce_trace(events, spans, (0, 100), [0])
    got = {(name, round(s * 1e9)) for name, s in r["idle_gaps"]}
    # card 0 idle [0, 20): ingest 10 + prep 10; [22, 30): device pass;
    # [35, 70): tail 15 (up to 50) + ingest 10 + prep 10 (first device
    # op of request 1 at 70, over both cards); [80, 100): device pass up
    # to 90 (card 1's last op), then tail 10
    assert got == {("ingest", 10), ("prep", 10), ("device_pass", 8),
                   ("tail", 15), ("device_pass", 10), ("tail", 10)}
    assert len(r["idle_gaps"]) == 8


def test_short_name_drops_the_return_type_and_cuts():
    assert yardstick.short_name("void k<int>(int)") == "k<int>(int)"
    assert len(yardstick.short_name("x" * 500)) == 120
