"""Finds what a benchmark cell needs by name: its entry in
`BENCHMARK.json`, its configuration (`configs/<name>.json`), its traffic
mix (`traffic/<name>.json`), the limits of its correctness check
(`limits/<cell>.json`), the reader of each of its metrics
(`metrics/<name>.py`), the spans a traced run of it wraps (those its
per-layer readers name in `SPANS`) and the module of each network its
configuration runs (`networks/<name>.py`). A later cell, metric or
network is added by adding files and entries; nothing here names one.

A configuration names its networks by role in the key `networks`, as
`{"features": "superpoint", "depth": "depthnet"}`: one `features`
network always, one `depth` network where the frontend predicts depth.
`networks/<name>.py` defines:

- `ROLE`: `"features"` or `"depth"`;
- `load(config, device)`: the program's model, through the port's public
  loaders, from the configuration's own keys (checkpoint, precision);
- `reference(config, device)`: the plain float32 reference's parameters,
  read from the checkpoint by the benchmark's own code;
- `flops_per_frame(config)`: the network's FLOPs a frame at the
  configuration's camera (`frozen/flops.py`);

and, for its role,

- `features`: `reference_features(params, gray_u8, frontend_cfg, quant)`
  -> `(xy, valid, desc)` of frames gray_u8 (F, H, W) uint8, with
  `frontend_cfg` the configuration's `slam.frontend` group;
- `depth`: `reference_depth_at(params, gray_u8, xy, quant)` -> metric
  depth (F, K) at full-resolution pixels xy (F, K, 2); the network's own
  output grid stays inside its module.

`quant`, when given, rounds each operation's inputs and weights (the
control). The system hands the `features` network to the entry as its
model and the `depth` network as its depth model."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")
NETWORKS = os.path.join(HERE, "networks")
ROLES = {"features": "reference_features", "depth": "reference_depth_at"}


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


def _load(path: str, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _module(metric_name: str, folder: str = None):
    path = os.path.join(folder or os.path.join(HERE, "metrics"), f"{metric_name}.py")
    return _load(path, f"slam_bench_metric_{metric_name}")


def reader(metric_name: str, folder: str = None):
    """The `read(run)` function of `metrics/<metric_name>.py`: returns
    the metric's value from a finished run's record, or None when the
    record holds nothing to read."""
    return _module(metric_name, folder).read


def networks(config: dict) -> dict:
    """{role: module} of the networks the configuration names in its
    `networks` key, each `NETWORKS/<name>.py` checked against the
    interface above. Raises before anything is loaded or rendered: a
    name with no module names the missing file."""
    named = config.get("networks")
    if not isinstance(named, dict) or "features" not in named:
        raise ValueError(f"configuration {config.get('name')!r} names no features network "
                         "in its `networks` key")
    out = {}
    for role, name in named.items():
        if role not in ROLES:
            raise ValueError(f"unknown network role {role!r}; roles: {sorted(ROLES)}")
        path = os.path.join(NETWORKS, f"{name}.py")
        if not os.path.isfile(path):
            raise FileNotFoundError(f"network {name!r} has no module: {path} is missing")
        mod = _load(path, f"slam_bench_network_{name}")
        wanted = ("ROLE", "load", "reference", "flops_per_frame", ROLES[role])
        missing = [a for a in wanted if not hasattr(mod, a)]
        if missing or mod.ROLE != role:
            raise ValueError(f"{path} does not serve the {role!r} role "
                             f"(ROLE {getattr(mod, 'ROLE', None)!r}, missing {missing})")
        out[role] = mod
    return out
