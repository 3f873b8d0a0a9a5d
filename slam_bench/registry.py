"""Finds what a benchmark cell needs by name: its entry in
`BENCHMARK.json`, its configuration (`configs/<name>.json`), its traffic
mix (`traffic/<name>.json`), the limits of its correctness check
(`limits/<cell>.json`), the reader of each of its metrics
(`metrics/<name>.py`) and the spans a traced run of it wraps (those its
per-layer readers name in `SPANS`). A later cell or metric is added by
adding files and entries; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(path: str = BENCHMARK) -> dict:
    return load_json(path)


def _by_name(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(name: str, bench: dict = None) -> dict:
    """Everything one cell runs on: the workload entry, its configuration
    and traffic files, its limits, its metrics (end-to-end and per-layer)
    and the spans its per-layer metrics read."""
    bench = bench or benchmark()
    w = _by_name(bench["workloads"], name, "workload")
    cfg_entry = _by_name(bench["configs"], w["config"], "config")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name) and m["moves"] in names]
    return dict(
        workload=w,
        config=load_json(os.path.join(ROOT, cfg_entry["file"])),
        traffic=traffic(w["traffic"]),
        limits=load_json(os.path.join(HERE, "limits", f"{name}.json")),
        end_to_end=e2e,
        per_layer=per_layer,
        spans=sorted({s for m in per_layer for s in getattr(_module(m["name"]), "SPANS", ())}),
    )


def traffic(name: str, folder: str = None) -> dict:
    return load_json(os.path.join(folder or os.path.join(HERE, "traffic"), f"{name}.json"))


def traffic_names(folder: str = None) -> list:
    folder = folder or os.path.join(HERE, "traffic")
    return sorted(f[:-5] for f in os.listdir(folder) if f.endswith(".json"))


def _module(metric_name: str, folder: str = None):
    path = os.path.join(folder or os.path.join(HERE, "metrics"), f"{metric_name}.py")
    spec = importlib.util.spec_from_file_location(f"slam_bench_metric_{metric_name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric_name: str, folder: str = None):
    """The `read(run)` function of `metrics/<metric_name>.py`: returns
    the metric's value from a finished run's record, or None when the
    record holds nothing to read."""
    return _module(metric_name, folder).read
