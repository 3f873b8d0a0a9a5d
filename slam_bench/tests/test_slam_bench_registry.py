"""The benchmark's files: every cell, configuration,
traffic mix and metric resolves by name, and names, units and bounds keep
to their rules."""

import importlib
import json
import os
import re

import pytest

from slam_bench import registry, trace

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(registry.BENCHMARK) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["slam_bench"]
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    for key, hi in (("configs", 24), ("workloads", 24), ("end_to_end", 16), ("per_layer", 128)):
        assert 1 <= len(BENCH[key]) <= hi


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(kind):
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
    }[kind]
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        assert set(e) <= allowed and NAME.match(e["name"])
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        if kind == "end_to_end":
            assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
        if kind == "per_layer":
            assert e["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")


def test_configs_name_their_changed_keys():
    for c in BENCH["configs"]:
        cfg = registry.load_json(os.path.join(registry.ROOT, c["file"]))
        assert c["file"].startswith("slam_bench/") and cfg["name"] == c["name"]
        assert set(c["reduced"]) == set(cfg["reduced"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
        assert c["source"] == cfg["source"]
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves(cell):
    spec = registry.cell(cell)
    w = spec["workload"]
    assert w["chips"] == 1 and NAME.match(w["traffic"]) and NAME.match(w["config"])
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and spec["per_layer"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(registry.reader(m["name"]))
    assert spec["limits"] and all(isinstance(v, (int, float)) for v in spec["limits"].values())
    t = spec["traffic"]
    assert t["streams"] == len(t["world_seeds"]) == len(t["orbit_radius_m"])


def test_per_layer_metrics_name_cells_that_report_what_they_move():
    for m in BENCH["per_layer"]:
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            moved = {e["name"] for e in registry.cell(cell)["end_to_end"]}
            assert m["moves"] in moved, (m["name"], cell)
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"entry", "frontend", "tracking step", "dense fusion", "CUDA kernels",
                      "device", "whole step"}


def test_at_most_a_quarter_of_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_a_dropped_in_traffic_file_is_found(tmp_path):
    mix = dict(registry.traffic("offline"), why="a wider orbit", orbit_radius_m=[4.0])
    (tmp_path / "wide.json").write_text(json.dumps(mix))
    for name in registry.traffic_names():
        (tmp_path / f"{name}.json").write_text(json.dumps(registry.traffic(name)))
    assert "wide" in registry.traffic_names(str(tmp_path))
    assert registry.traffic("wide", str(tmp_path))["orbit_radius_m"] == [4.0]


def test_a_dropped_in_metric_reader_is_found(tmp_path):
    (tmp_path / "calls_seen.py").write_text("def read(run):\n    return len(run.calls)\n")

    class Run:
        calls = [1, 2, 3]

    assert registry.reader("calls_seen", str(tmp_path))(Run()) == 3


def test_span_files_name_attributes_of_the_program():
    defs = trace.span_defs()
    assert {"frontend", "track", "track_batched", "fuse", "radius", "radius_batched"} <= set(defs)
    for d in defs.values():
        assert callable(getattr(importlib.import_module(d.MODULE), d.ATTR))


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_wraps_only_the_spans_its_metrics_read(cell):
    spec = registry.cell(cell)
    assert set(spec["spans"]) <= set(trace.span_defs())
    read = {s for m in spec["per_layer"]
            for s in getattr(registry._module(m["name"]), "SPANS", ())}
    assert set(spec["spans"]) == read
    if not spec["config"]["slam"]["rgbd"]:
        assert "fuse" not in spec["spans"]  # nothing to fuse: not wrapped


def test_a_dropped_in_span_file_changes_no_cell(tmp_path):
    for f in os.listdir(os.path.join(registry.HERE, "spans")):
        if f.endswith(".py"):
            (tmp_path / f).write_text(open(os.path.join(registry.HERE, "spans", f)).read())
    (tmp_path / "loop_check.py").write_text(
        'MODULE, ATTR = "vslam_tpu_torch.core.tracking", "tracking_step"\n'
        "def frames(a):\n    return 1\n")
    assert "loop_check" in trace.span_defs(folder=str(tmp_path))
    wanted = registry.cell("rgbd_sp640.offline")["spans"]
    assert set(trace.span_defs(set(wanted), str(tmp_path))) == set(wanted)


def test_only_the_nested_spans_skip_their_syncs():
    defs = trace.span_defs()
    assert {n for n, d in defs.items() if not getattr(d, "SYNC", True)} == {
        "radius", "radius_batched"}
