"""BENCHMARK.json against the benchmark's contract: its keys, names and
units, the files it names, and the readers the harness finds by name."""

import json
import re
from pathlib import Path

import pytest

from lapbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "lapbench/run.py"]
    assert BENCH["paths"] == ["lapbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_names_units_and_keys(m):
    assert NAME.match(m["name"])
    assert UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if "bound" in m:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
        assert m["unit"] == "%"
    assert callable(harness.reader(m["name"]))


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_every_cell_reports_setup_another_metric_and_a_layer(cell):
    spec = harness.load_cell(cell["name"], BENCH)
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
    assert cell["chips"] in (1, 4)
    assert NAME.match(cell["traffic"])
    assert 1 <= len(cell["why"]) <= 200


def test_configs_name_their_files_under_paths():
    used = {c["config"] for c in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("lapbench/configs/")
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert len(c["source"]) <= 200 and c["source"].startswith("https://")
        assert {"not_found", "bad_rows", "gap"} <= set(cfg["limits"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_each_cell_names_modules_that_exist(cell):
    """The entry, generator and pattern a cell runs are modules found by
    the names in its configuration and traffic files."""
    from lapbench import drivers
    spec = harness.load_cell(cell["name"], BENCH)
    assert callable(drivers.plugin("entries", spec["config"]["entry"]).call)
    assert callable(drivers.plugin("generators",
                                   spec["config"]["generator"]).make)
    assert callable(drivers.plugin("patterns",
                                   spec["traffic"]["pattern"]).Pattern)


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = sum(c["chips"] == 4 for c in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_pairs_of_configuration_and_traffic_are_unique():
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_check_budget_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
