"""Tracing / profiling utilities.

The program's span recorder (`span`, `recording`, `count_read`,
`count`): spans at the layer boundaries of `core.coupled`, around the
frontend's depth network and inside the tracking step, kept in memory
while the recorder is on, each with the branch predicates read back
inside it and what the code inside it counted. `StageTimer`, an
accumulating stage timer over the
same records, a step-metrics recorder that turns `StepOutputs`
diagnostics into a structured log, and the attribution apps' shared
timing (`bench_device`, `seconds_per_iter`, `device_activities`).
"""

from __future__ import annotations

import contextlib
import json
import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- the span recorder --------------------------------------------------
#
# Off by default. Its clock is `time.time_ns()`, the host's wall clock:
# the clock the benchmark's own spans read and the one its device trace
# is mapped onto (through the first marker kernel's start), so a span
# and a device record compare with no conversion. A span reads the clock
# at its edges only: it never waits for the card, so a wait for the card
# lands in the span that reads a device value back (a branch read).


@dataclass(slots=True)
class SpanRecord:
    """One span, and the context manager that records it. `parent` is
    the index of the span it opened in (-1 at the top) and `call` that of
    the top-level span it belongs to (the entry call), in the recorder's
    list; `frames` the frames it covers (member-frames in the batched
    step); `ids` the host frame ids where the caller holds them; `reads`
    the branch predicates read back while it was the innermost open
    span; `counts` what `count` charged to it while it was the innermost
    open span, by name (None when nothing was)."""

    name: str
    frames: int = 1
    ids: object = None
    parent: int = -1
    call: int = -1
    t0_ns: int = 0
    t1_ns: int = 0
    reads: int = 0
    counts: dict = None

    def __enter__(self):
        rec = _REC
        index = len(rec.records)
        self.parent = rec.open[-1] if rec.open else -1
        self.call = rec.records[self.parent].call if self.parent >= 0 else index
        rec.records.append(self)
        rec.open.append(index)
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1_ns = time.time_ns()
        if _REC.open:
            _REC.open.pop()
        return False


class _Recorder:
    """The records (None while the recorder is off) and the indices of
    the open spans, innermost last."""

    __slots__ = ("records", "open")

    def __init__(self):
        self.records = None
        self.open = []


class _NoSpan:
    """What `span` gives while the recorder is off: one shared object
    that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_REC = _Recorder()
_NO_SPAN = _NoSpan()


def span(name: str, frames: int = 1, ids=None):
    """A span named `name` around a `with` block. While the recorder is
    off it is one shared no-op object: no clock read, nothing kept,
    nothing launched or read from the device."""
    if _REC.records is None:
        return _NO_SPAN
    return SpanRecord(name, frames, ids)


def count_read():
    """Charge one branch read (a predicate read back from the device) to
    the innermost open span; nothing while the recorder is off."""
    rec = _REC
    if rec.open:
        rec.records[rec.open[-1]].reads += 1


def count(name: str, n: int):
    """Add `n` (a host number: nothing is read from the device) to the
    count `name` of the innermost open span; nothing while the recorder
    is off."""
    rec = _REC
    if rec.open:
        r = rec.records[rec.open[-1]]
        if r.counts is None:
            r.counts = {}
        r.counts[name] = r.counts.get(name, 0) + n


def start_recording() -> list:
    """Switch the recorder on (one already on stays as it is); returns
    the list its records go into, in the order the spans opened."""
    if _REC.records is None:
        _REC.records, _REC.open = [], []
    return _REC.records


def stop_recording() -> list:
    """Switch the recorder off and hand over its records (none when it
    was off); the module keeps nothing."""
    records = _REC.records if _REC.records is not None else []
    _REC.records, _REC.open = None, []
    return records


@contextlib.contextmanager
def recording():
    """The recorder on for the block; yields its records. Inside another
    recording it yields that one's records and leaves it on."""
    was_on = _REC.records is not None
    records = start_recording()
    try:
        yield records
    finally:
        if not was_on:
            stop_recording()


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
    """Accumulating stage timer over the span recorder: each `stage` is
    a span (the recorder is on for it), and `totals`, `counts` and
    `report` read the records of the timer's own stages, by name."""

    records: List[SpanRecord] = field(default_factory=list)

    @contextlib.contextmanager
    def stage(self, name: str, result_tree=None):
        """Times the block; put the block's result in the yielded dict
        under "result" to wait for it before the span closes."""
        box = {}
        with recording(), span(name) as rec:
            self.records.append(rec)
            try:
                yield box
            finally:
                if "result" in box:
                    force_completion(box["result"])

    @property
    def totals(self) -> Dict[str, float]:
        """Seconds by stage name."""
        out = {}
        for r in self.records:
            out[r.name] = out.get(r.name, 0.0) + (r.t1_ns - r.t0_ns) / 1e9
        return out

    @property
    def counts(self) -> Dict[str, int]:
        """Stages run, by name."""
        out = {}
        for r in self.records:
            out[r.name] = out.get(r.name, 0) + 1
        return out

    def report(self) -> str:
        totals, counts = self.totals, self.counts
        lines = []
        for k in sorted(totals, key=lambda k: -totals[k]):
            lines.append(
                f"{k:24s} {totals[k]*1000:9.1f} ms total "
                f"({totals[k]/max(counts[k],1)*1000:7.2f} ms x{counts[k]})"
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
