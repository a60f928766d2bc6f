"""The ``csc_s`` reader (``lapbench/metrics/csc_s.py``): the seconds of
the program's ``csc`` span inside ``host_tables``, on the synthetic run
and recorder buffer of ``test_lapbench_program_spans``; None without a
recorder, from a wrapped buffer, or from a program that records no
``csc`` span; and a traced CPU run of each cell that lists it."""

import pytest

from lapbench import harness, program_spans
from lapbench.tests.test_lapbench_program_spans import (BUFFER, RUN, _fake,
                                                        _rec)
from lapbench.tests.test_lapbench_run import _run


def _with_csc(recs):
    """``recs`` with a ``csc`` span of 0.25 s inside each request's
    ``host_tables`` (its ids past those of the request)."""
    out = list(recs)
    for s in recs:
        if s["name"] == "host_tables":
            out.append(_rec("csc", s["root"] + 50, s["id"], s["root"],
                            s["t0"] + 1.0, s["t0"] + 1.25))
    return out


BUFFER_CSC = _with_csc(BUFFER)


def test_csc_reads_the_span_of_each_window_request(monkeypatch):
    monkeypatch.setattr(program_spans, "_recorder",
                        lambda: _fake(BUFFER_CSC))
    assert harness.reader("csc_s")(RUN) == pytest.approx(0.25)
    # the span lies inside host_tables, which it does not change
    assert harness.reader("host_tables_s")(RUN) == pytest.approx(1.5)


@pytest.mark.parametrize("recorder", ["none", "no_csc_span", "wrapped"])
def test_csc_gives_none_where_there_is_nothing_to_read(monkeypatch,
                                                       recorder):
    window = [s for s in BUFFER_CSC if s["root"] > 1]
    fake = {"none": None,
            "no_csc_span": _fake(BUFFER),
            "wrapped": _fake(window, max_spans=len(window))}[recorder]
    monkeypatch.setattr(program_spans, "_recorder", lambda: fake)
    assert harness.reader("csc_s")(RUN) is None


@pytest.mark.parametrize("cell", ["sparse1M.cold", "sparse1M.track"])
def test_a_traced_cpu_run_reports_csc(cell):
    r = _run(cell, trace=True)
    assert r["correct"] is True
    listed = [m["name"] for m in harness.load_cell(cell)["per_layer"]
              if m["name"].startswith("csc_s.")]
    assert listed
    for name in listed:
        assert r["metrics"][name]["value"] >= 0, name
