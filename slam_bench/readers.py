"""Arithmetic the metric readers (`metrics/<name>.py`) share. Each takes
the record of a finished run (`run.Record`) and returns a number, or None
when the record holds nothing to read."""

from __future__ import annotations

import numpy as np

from slam_bench.frozen import radius_work as rw
from slam_bench.trace import busy_intervals

H100_BF16_FLOPS = rw.H100_BF16_FLOPS


def span_ms_per_frame(run, *names):
    """Milliseconds per frame (member-frame with several streams) in the
    window's spans `names`."""
    spans = [s for s in run.spans if s.name in names and s.in_window]
    frames = sum(s.frames for s in spans)
    if not frames:
        return None
    return sum(s.t1_ns - s.t0_ns for s in spans) / 1e6 / frames


def idle_share(run):
    p = run.profile
    if not p or p["span1"] <= p["span0"]:
        return None
    bs, be = busy_intervals(p["start"], p["end"])
    return 100.0 * (1.0 - (be - bs).sum() / (p["span1"] - p["span0"]))


def radius_roofline(run, name):
    """The least time of the traced chunk's radius matches on their own
    inputs (`frozen.radius_work`), over the device time of the records
    between each match's own markers, in %."""
    p = run.profile
    marked = [s for s in run.spans if s.profiled and s.kept is not None]
    if not p or len(p["marked"]) != len(marked):
        return None
    floor = device = 0.0
    for s, (i, j) in zip(marked, p["marked"]):
        if s.name == name:
            w = rw.radius_work(**s.kept_on_host())
            floor += rw.bound_s(w["nbytes"], w["flops"])
            device += (p["end"][i:j] - p["start"][i:j]).sum() / 1e9
    return 100.0 * floor / device if device > 0 else None


def kernels_per_frame(run):
    p = run.profile
    if not p or not run.profile_frames:
        return None
    return len(p["names"]) / run.profile_frames


def frame_mfu(run):
    p = run.profile
    if not p or p["span1"] <= p["span0"] or not run.profile_frames:
        return None
    window_s = (p["span1"] - p["span0"]) / 1e9
    return 100.0 * run.flops_per_frame * run.profile_frames / window_s / H100_BF16_FLOPS


def p95(values):
    return float(np.percentile(np.asarray(values, np.float64), 95)) if len(values) else None
