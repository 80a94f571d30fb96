"""BENCHMARK.json against the characters its names and units may use, and the harness finding
a cell, a configuration and a metric by name alone."""

import json
import re
import shutil

import pytest

from pokerbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = run.manifest()


def _names():
    out = []
    for c in BENCH["configs"]:
        out += [c["name"]] + list(c["reduced"])
    for w in BENCH["workloads"]:
        out += [w["name"], w["config"], w["traffic"]]
    out += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    return out


@pytest.mark.parametrize("name", _names())
def test_name_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    run.reader(metric["name"])  # its reader file exists and defines read()
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "layer" in metric:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files(cell):
    wl, conf, traffic = run.cell(BENCH, cell)
    assert wl["chips"] in (1, 4)
    assert conf["reduced"] == next(c for c in BENCH["configs"] if c["name"] == wl["config"])["reduced"]
    assert (run.ROOT / "pokerbench" / "drivers" / f"{traffic['driver']}.py").exists()
    assert any(m["name"] == "setup_s" for m in run.metrics_for(BENCH, cell, False))
    assert len(run.metrics_for(BENCH, cell, False)) >= 2 and run.metrics_for(BENCH, cell, True)


def test_new_cell_and_metric_are_data_only(tmp_path):
    """A cell and a metric added to a copy as new files and manifest entries
    are found, with no other file edited."""
    shutil.copytree(run.ROOT / "pokerbench", tmp_path / "pokerbench")
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "pokerbench").rglob("*") if p.is_file()}
    traffic = json.loads((tmp_path / "pokerbench/workloads/shuffle52.table.json").read_text())
    traffic.update(batch=4, fuse_b_max=4)
    (tmp_path / "pokerbench/workloads/shuffle52.b4.json").write_text(json.dumps(traffic))
    (tmp_path / "pokerbench/metrics/calls_in_window.py").write_text("def read(run):\n    return len(run.window.calls)\n")
    bench["workloads"].append({"name": "shuffle52.b4", "config": "shuffle52", "traffic": "batch4", "chips": 1,
                               "why": "four decks a call"})
    bench["per_layer"].append({"name": "calls_in_window", "unit": "calls", "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "shuffle_pairs_per_s", "workloads": ["shuffle52.b4"]})
    bench["end_to_end"][0]["workloads"].append("shuffle52.b4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    wl, conf, got = run.cell(bench, "shuffle52.b4", tmp_path)
    assert got["batch"] == 4 and conf["n"] == 26
    assert [m["name"] for m in run.metrics_for(bench, "shuffle52.b4", True)] == ["calls_in_window"]
    assert run.reader("calls_in_window", tmp_path)(run.Run("decks", 1.0, _Win(), {}, {}, None)) == 3
    after = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "pokerbench").rglob("*") if p.is_file()}
    assert {k: v for k, v in after.items() if k in before} == before


class _Win:
    calls = [1, 2, 3]
