"""Tracing / profiling utilities.

Port of `vslam_tpu/utils/profiling.py`: a `torch.profiler` trace of the
card's activity exported as a Chrome trace, stage timers that wait for the
device before they read the clock, and a step-metrics recorder that turns
`StepOutputs` diagnostics into a structured log.
"""

from __future__ import annotations

import contextlib
import json
import os
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
