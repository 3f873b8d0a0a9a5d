"""Runs one cell of the benchmark of `vslam_tpu_torch` once:

    python3 -m slam_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. Set-up renders the cell's worlds, loads the program and runs one
warm-up at the cell's shapes; the window then runs whole calls of the
entry back to back and ends with the first call that ends at or after
`--seconds`. After it, the outputs are checked against the plain
reference (`check.py`). The last line of standard output is the result
as one JSON object; with `--trace 0` its metrics are the cell's
end-to-end metrics, with `--trace 1` its per-layer ones (spans, one
traced chunk, the host's syncs). `--seed` draws which later sequence is
checked besides the first; the worlds are the traffic file's.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from slam_bench import registry  # noqa: E402
from slam_bench.frozen import flops  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vslam_tpu")
PORT = os.path.join(registry.ROOT, "vslam_tpu_torch")
CACHE = os.path.join(registry.HERE, ".cache")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark may not
    load (compared whole: `vslam_tpu_torch` is not `vslam_tpu`)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def fixed_caches():
    """Build and kernel caches at fixed paths inside the checkout (the
    port builds its CUDA library in its own `_build/`)."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions"))


@dataclasses.dataclass
class Record:
    """Everything a run leaves for the metric readers."""

    calls: list
    streams: int
    calls_per_sequence: int
    setup_s: float
    ate_m: float = None
    spans: list = dataclasses.field(default_factory=list)
    profile: dict = None
    profile_frames: int = 0
    host_syncs: int = None
    flops_per_frame: float = 0.0

    @property
    def frames(self) -> int:
        return sum(c.t.shape[0] for c in self.calls) * self.streams

    def whole_sequences(self) -> list:
        n = {}
        for c in self.calls:
            n[c.sequence] = n.get(c.sequence, 0) + 1
        return sorted(s for s, k in n.items() if k == self.calls_per_sequence)

    def fps(self):
        whole = set(self.whole_sequences())
        frames = sum(c.t.shape[0] for c in self.calls if c.sequence in whole) * self.streams
        span = self.calls[-1].end - self.calls[0].start
        return frames / span if frames and span > 0 else None

    def latencies_ms(self) -> list:
        return [(c.end - c.start) * 1e3 for c in self.calls]


def card_line(dev) -> dict:
    import torch

    if dev.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1)
    out = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=1)
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        out["power_limit"] = q.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        out["power_limit"] = "not read"
    return out


def model_flops_per_frame(config: dict) -> float:
    """The FLOPs of each network the configuration names and of the
    tracking step's matmuls, a frame."""
    s = config["slam"]
    fc, m = s["frontend"], s["map"]
    f = flops.tracking_flops_per_frame(fc["max_keypoints"], fc["descriptor_dim"],
                                       m["map_capacity"])
    return f + sum(net.flops_per_frame(config) for net in registry.networks(config).values())


def run_window(system, hooks, seconds: float, rng):
    """Whole calls back to back until one ends at or after `seconds`.
    Captures the frontend's outputs and the dense map of the first whole
    sequence and of one later whole sequence drawn by reservoir sampling.
    Returns (calls, {sequence: (frontend outputs, dense map)})."""
    per_seq = system.N // system.per_call
    calls, samples = [], {}
    t0 = time.perf_counter()
    while True:
        seq, pos = divmod(system.calls_done, per_seq)
        if pos == 0:
            hooks.capture = seq == 0 or rng.random() < 1.0 / seq
            hooks.captured = []
        call = system.next_call(system.config["ransac_seed"])
        calls.append(call)
        if hooks.capture and pos == per_seq - 1:
            if seq > 0:
                samples = {s: v for s, v in samples.items() if s == 0}
            samples[seq] = (hooks.captured, system.last_dense)
        if call.end - t0 >= seconds:
            return calls, samples


def check_outputs(system, record, samples, limits, dev):
    """The numbers of `check.py` named in `limits`, and the first whole
    sequence's ATE into `record.ate_m`."""
    import torch

    from slam_bench import check
    from slam_bench.reference.trajectory import ate_rmse

    cfg, B = system.config, system.B
    with_scale = not cfg["slam"]["rgbd"]
    gt = system.world["t"]
    worst = 0.0
    for k, seq in enumerate(record.whole_sequences()):
        err = check.pose_errors(check.sequence_poses(record.calls, seq, B), gt, with_scale)
        worst = max(worst, float(err.max()) if np.isfinite(err).all() else np.inf)
        if k == 0:
            record.ate_m = ate_rmse(err)
    numbers = {"pose_err_m": worst if record.whole_sequences() else float("inf")}
    for seq, (captured, dense) in sorted(samples.items()):
        if "kp_miss" in limits or "desc_gap" in limits or "depth_gap" in limits:
            gray = system.gray.flatten(0, 1) if B > 1 else system.gray[:, 0]
            got = check.frontend_numbers(check.features_of(captured), gray, cfg, dev)
            for key, v in got.items():
                numbers[key] = max(numbers.get(key, 0.0), v)
        if "cloud_diff" in limits:
            R = check.sequence_rotations(record.calls, seq, B)
            t = check.sequence_poses(record.calls, seq, B)
            numbers["cloud_diff"] = numbers.get("cloud_diff", 0) + check.cloud_number(
                dense, R, t, system.world["depth_u16"], cfg)
        del captured, dense
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return numbers


def failed_frames(calls, B: int) -> int:
    """Frames (of every stream) whose pose is not finite, or that did not
    track after their sequence's first frame."""
    n = 0
    for c in calls:
        ok = c.tracking_ok.reshape(c.t.shape[0], B).astype(bool)
        finite = np.isfinite(c.t.reshape(c.t.shape[0], B, 3)).all(-1)
        first = (np.arange(c.t.shape[0]) + c.first_frame == 0)[:, None]
        n += int((~finite | (~ok & ~first)).sum())
    return n


def run_cell(spec: dict, seed: int, seconds: float, traced: bool, device="cuda",
             t_start: float = None, workers: int = None, log=sys.stderr) -> dict:
    """One run of a cell (`registry.cell`'s dict). Returns the result
    line's object."""
    import torch

    from slam_bench import check
    from slam_bench.frozen import syncs
    from slam_bench.system import RENDER_WORKERS, System
    from slam_bench.trace import Hooks, device_ops, idle_by_span

    t_start = T_START if t_start is None else t_start
    dev = torch.device(device)
    cfg, traffic = spec["config"], spec["traffic"]
    t_system = time.perf_counter()
    system = System(cfg, traffic, device=dev, workers=workers or RENDER_WORKERS)
    t_warm = time.perf_counter()
    system.warm_up(cfg["ransac_seed"])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    split = dict(start_s=t_system - t_start, render_s=system.render_s,
                 load_s=t_warm - t_system - system.render_s, warm_up_s=time.perf_counter() - t_warm)
    hooks = Hooks(traced, traffic["profile_frames"], traffic["chunk"], spec["spans"])
    setup_s = time.perf_counter() - t_start
    rng = np.random.default_rng(seed)
    sites = collections.Counter()
    try:
        hooks.in_window = True
        if traced:
            with syncs.count_host_syncs([PORT], sites):
                calls, samples = run_window(system, hooks, seconds, rng)
        else:
            calls, samples = run_window(system, hooks, seconds, rng)
        hooks.in_window = hooks.capture = False
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        if traced:
            system.traced_call(hooks, cfg["ransac_seed"])
    finally:
        hooks.remove()
    record = Record(calls, system.B, system.N // system.per_call, setup_s)
    # The program's state goes before the reference runs.
    system.state = system.dense = system.state0 = system.dense0 = system.last_dense = None
    system.model = system.depth_model = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    limits = spec["limits"]
    numbers = check_outputs(system, record, samples, limits, dev)
    samples.clear()
    correct = check.judge(numbers, limits)
    if traced:
        record.spans = hooks.spans
        record.profile = hooks.profile
        record.profile_frames = traffic["profile_frames"] * system.B if hooks.profile else 0
        record.host_syncs = sum(sites.values())
        record.flops_per_frame = model_flops_per_frame(cfg)
    metrics_spec = spec["per_layer"] if traced else spec["end_to_end"]
    metrics = {}
    for m in metrics_spec:
        v = registry.reader(m["name"])(record)
        if v is not None and np.isfinite(v):
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    card = card_line(dev)
    line = dict(correct=bool(correct), attempted=record.frames,
                failed=failed_frames(calls, system.B), metrics=metrics,
                device=dict(platform=card["platform"], kind=card["kind"], count=card["count"],
                            memory_peak_bytes=int(peak)))
    lat = record.latencies_ms()
    info = dict(
        cell=spec["workload"]["name"], seed=seed, traced=traced, power_limit=card.get(
            "power_limit"), setup_s=setup_s, setup_split=split, calls=len(calls),
        whole_sequences=len(record.whole_sequences()), frames=record.frames,
        window_s=calls[-1].end - calls[0].start, fps=record.fps(),
        call_ms=[round(x, 3) for x in lat[:8]], latency_ms_median=float(np.median(lat)),
        latency_ms_p95=float(np.percentile(lat, 95)), latency_samples=len(lat),
        ate_m=record.ate_m, replays_equal=_replays_equal(calls, record),
        memory_peak_bytes=int(peak), missing_spans=hooks.missing)
    if traced:
        p = hooks.profile
        info.update(host_sync_sites=dict(sites.most_common(8)),
                    profile_whole=p is not None)
        if p is not None:
            info.update(profile_records=len(p["names"]), clock_shift_ns=int(p["shift_ns"]),
                        radius_spans=_radius_records(p))
        if p is not None:
            from slam_bench.readers import idle_share

            window_s = (p["span1"] - p["span0"]) / 1e9
            line["device"]["busy_s"] = window_s * (1.0 - idle_share(record) / 100.0)
            line["device"]["window_s"] = window_s
            line["breakdown"] = dict(device_ops=device_ops(p),
                                     idle_gaps=idle_by_span(p, hooks.spans))
    print("info " + json.dumps(info), flush=True)
    # A number that could not be read (no whole sequence, a pose not
    # finite) is null, and fails.
    line["checks"] = {k: {"value": float(numbers[k]) if np.isfinite(numbers.get(k, np.nan))
                          else None, "limit": float(v)} for k, v in limits.items()}
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=log, flush=True)
    return line


def _radius_records(p):
    """Per marked span of the trace: (records, their device us)."""
    return [(j - i, round(float((p["end"][i:j] - p["start"][i:j]).sum()) / 1e3, 3))
            for i, j in p["marked"][:8]]


def _replays_equal(calls, record):
    """Whether every later whole sequence gave the first's poses to the
    last digit (None with one)."""
    seqs = record.whole_sequences()
    if len(seqs) < 2:
        return None
    t = [np.concatenate([c.t for c in calls if c.sequence == s]) for s in seqs]
    return all(np.array_equal(t[0], x) for x in t[1:])


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    spec = registry.cell(args.workload)
    chips = spec["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    fixed_caches()
    line = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"error: modules the benchmark may not load are loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
