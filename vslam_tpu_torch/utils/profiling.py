"""Tracing / profiling utilities.

Port of `vslam_tpu/utils/profiling.py`: a `torch.profiler` trace of the
card's activity exported as a Chrome trace, stage timers that wait for the
device before they read the clock, and a step-metrics recorder that turns
`StepOutputs` diagnostics into a structured log. Also the attribution
apps' shared timing (`bench_device`, `seconds_per_iter`,
`device_activities`).
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace what runs inside with `torch.profiler` (CPU activity, and the
    card's when one is present); writes `trace.json` (Chrome trace format)
    under `log_dir` and yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def bench_device(args, app: str) -> torch.device:
    """The device an attribution app runs on: the CPU with `--cpu`, else
    the card; raises when there is none."""
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device: {app} runs on the card (pass --cpu for the CPU)")
    return torch.device("cuda")


def seconds_per_iter(fn, n: int, dev: torch.device, reps: int = 3, warm: bool = True) -> float:
    """Median over `reps` runs of `n` calls of `fn`, per call, after one
    warm call (unless `warm` is False: the caller has warmed what `fn`
    runs): CUDA events on the card (the stream's time from the first
    launch of a run to the end of its last, host gaps included), the host
    clock on the CPU."""
    if warm:
        fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            times.append(time.perf_counter() - t0)
    return statistics.median(times) / n


# The kernel of `torch.cuda._sleep`: the markers that frame a counted call.
MARKER_KERNEL = "spin_kernel"
# The host's idle time at each edge of a `device_activities` session.
EDGE_PAD_S = 0.05
# `device_activities` sessions: whole, and run again for a missing marker.
SESSIONS = {"whole": 0, "lost": 0}


def _start_ns(e):
    return e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000


def framed_session(fn, pad_s: float = EDGE_PAD_S) -> list:
    """The card's records of one call of `fn` in a `torch.profiler`
    session (CUDA activity only), framed: the host idles `pad_s`, two
    primer kernels and a marker kernel (`torch.cuda._sleep`) go first,
    a marker last, and the host idles `pad_s` again. Returns the records'
    names in the order they started."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    primer = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        primer.add_(1)
        primer.add_(1)
        torch.cuda._sleep(1)
        fn()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        time.sleep(pad_s)
    evs = sorted((e for e in prof.profiler.kineto_results.events() if e.device_type() == cuda),
                 key=_start_ns)
    return [e.name() for e in evs]


def framed_count(names):
    """The records between the two markers of `framed_session`'s names
    (the call's own: one stream runs them in order); None when a marker
    is missing."""
    marks = [i for i, n in enumerate(names) if MARKER_KERNEL in n]
    return marks[1] - marks[0] - 1 if len(marks) == 2 else None


def device_activities(fn, dev: torch.device, tries: int = 3):
    """Kernels, copies and fills one call of `fn` puts on the card
    (`torch.profiler`, CUDA activity only; None on the CPU). Run it after
    the timings: a finished profiler session slows later launches.

    A session's trace can lack the first records of the card (on an H100:
    a run of them in ~1% of sessions that launch at once, the record's
    converted start falling before the session's; in a process that has
    run for a while, often the first record after the host's idle), and a
    short call then read 0. So the call runs in a `framed_session`; its
    count is the records between the markers, and a session that lacks a
    marker is run again, up to `tries` sessions; None when no session was
    whole. `SESSIONS` counts both kinds."""
    if dev.type != "cuda":
        return None
    for _ in range(tries):
        n = framed_count(framed_session(fn))
        if n is not None:
            SESSIONS["whole"] += 1
            return n
        SESSIONS["lost"] += 1
    return None


def _device_of(tree):
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for x in tree:
            d = _device_of(x)
            if d is not None:
                return d
    return None


def force_completion(tree, device=None):
    """Wait until the work behind `tree` (tensors, possibly nested in
    tuples, lists or dicts) has finished: `torch.cuda.synchronize` on the
    card, nothing on the CPU, where ops complete as they return."""
    dev = torch.device(device) if device is not None else _device_of(tree)
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return tree


@dataclass
class StageTimer:
    """Accumulating wall-clock stage timer with completion forcing."""

    totals: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, result_tree=None):
        """Times the block; put the block's result in the yielded dict
        under "result" to wait for it before the clock is read."""
        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            if "result" in box:
                force_completion(box["result"])
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for k in sorted(self.totals, key=lambda k: -self.totals[k]):
            lines.append(
                f"{k:24s} {self.totals[k]*1000:9.1f} ms total "
                f"({self.totals[k]/max(self.counts[k],1)*1000:7.2f} ms x{self.counts[k]})"
            )
        return "\n".join(lines)


def step_metrics_log(outputs, path=None) -> List[dict]:
    """StepOutputs -> per-frame structured metrics (JSONL when `path`)."""
    o = outputs
    fields = {name: _host(getattr(o, name)) for name in
              ("num_matches", "num_inliers", "num_tracked", "is_keyframe", "used_3d3d",
               "tracking_ok")}
    rows = []
    for i in range(fields["num_matches"].shape[0]):
        rows.append({
            "frame": i,
            "matches": int(fields["num_matches"][i]),
            "inliers": int(fields["num_inliers"][i]),
            "tracked": int(fields["num_tracked"][i]),
            "keyframe": bool(fields["is_keyframe"][i]),
            "used_3d3d": bool(fields["used_3d3d"][i]),
            "tracking_ok": bool(fields["tracking_ok"][i]),
        })
    if path:
        with open(path, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return rows


def summarize_run(outputs) -> dict:
    """Run-level counts and means of StepOutputs diagnostics; epipolar
    means over the frames where the F-gate ran (epi_before > 0)."""
    o = outputs
    g = lambda name: _host(getattr(o, name))  # noqa: E731
    out = {
        "frames": int(g("num_matches").shape[0]),
        "mean_matches": float(g("num_matches").mean()),
        "mean_inliers": float(g("num_inliers").mean()),
        "mean_tracked": float(g("num_tracked").mean()),
        "keyframes": int(g("is_keyframe").sum()),
        "tracked_frac": float(g("tracking_ok").mean()),
        "used_3d3d_frac": float(g("used_3d3d").mean()),
    }
    for name in ("bridged", "recovered"):
        if getattr(o, name, None) is not None:
            out[name + "_count"] = int(g(name).sum())
    if getattr(o, "epi_before", None) is not None and getattr(o, "epi_after", None) is not None:
        eb, ea = g("epi_before"), g("epi_after")
        ran = eb > 0
        out["fgate_frames"] = int(ran.sum())
        out["epi_before_mean_px"] = float(eb[ran].mean()) if ran.any() else 0.0
        out["epi_after_mean_px"] = float(ea[ran].mean()) if ran.any() else 0.0
    return out
