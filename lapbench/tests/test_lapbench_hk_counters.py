"""The ``hk_passes`` and ``hk_augmented`` readers
(``lapbench/metrics/hk_passes.py``, ``hk_augmented.py``): the counters
``passes`` and ``augmented`` of the program's ``hk`` span, on the
synthetic run and recorder buffer of ``test_lapbench_program_spans``;
None without a recorder, from a wrapped buffer, or from a program whose
``hk`` span holds no such counter; and a traced CPU run of the cell that
lists them."""

import pytest

from lapbench import harness, program_spans
from lapbench.tests.test_lapbench_program_spans import (BUFFER, RUN, _fake,
                                                        _request)
from lapbench.tests.test_lapbench_run import _run

# request 0 (t = 100) counts 2 passes and 60 rows, request 1 (t = 200) 3
# and 90; the warm-up's root (t = 5) 7 and 700, outside the window
COUNTS = {5: (7, 700), 100: (2, 60), 200: (3, 90)}
EXPECT = {"hk_passes": 2.5, "hk_augmented": 75.0}
NAMES = sorted(EXPECT)


def _with_counts(recs):
    """``recs`` with the counters on each request's ``hk`` span (a copy:
    ``BUFFER`` itself stays as it is)."""
    out = []
    for s in recs:
        s = dict(s, counts=dict(s["counts"]))
        if s["name"] == "hk":
            passes, augmented = COUNTS[int(s["t0"]) - 1]
            s["counts"].update(passes=passes, augmented=augmented)
        out.append(s)
    return out


BUFFER_HK = _with_counts(BUFFER)


@pytest.mark.parametrize("name", NAMES)
def test_reads_the_counters_of_each_window_request(monkeypatch, name):
    monkeypatch.setattr(program_spans, "_recorder",
                        lambda: _fake(BUFFER_HK))
    assert harness.reader(name)(RUN) == pytest.approx(EXPECT[name])
    # the counters do not move the span's seconds
    assert harness.reader("hk_s")(RUN) == pytest.approx(1.0)


@pytest.mark.parametrize("recorder", ["none", "no_counters", "wrapped"])
@pytest.mark.parametrize("name", NAMES)
def test_gives_none_where_there_is_nothing_to_read(monkeypatch, name,
                                                   recorder):
    window = _with_counts(_request(101, 100) + _request(201, 200))
    fake = {"none": None,
            "no_counters": _fake(BUFFER),
            "wrapped": _fake(window, max_spans=len(window))}[recorder]
    monkeypatch.setattr(program_spans, "_recorder", lambda: fake)
    assert harness.reader(name)(RUN) is None


def test_a_traced_cpu_run_of_the_cold_cell_reports_both():
    r = _run("sparse1M.cold", trace=True)
    assert r["correct"] is True
    listed = [m["name"] for m in harness.load_cell("sparse1M.cold")
              ["per_layer"] if m["name"].split(".")[0] in EXPECT]
    assert sorted(listed) == ["hk_augmented.solve", "hk_passes.solve"]
    passes = r["metrics"]["hk_passes.solve"]["value"]
    assert passes >= 1
    assert r["metrics"]["hk_augmented.solve"]["value"] >= 0
