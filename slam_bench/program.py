"""The program's own spans in a traced run, and what is read from them.

`vslam_tpu_torch.utils.profiling` records spans inside the program: at
the layer boundaries of its entry (`entry`, `entry.copy`, `frontend`,
`track`, `pgo`, `fuse`) and around the blocks of the tracking step
(`step`, `step.bootstrap`, `step.match`, `step.motion`, `step.map`,
`step.pose`, `step.keyframe`, `step.finish`), each with the branch
predicates read back while it was the innermost open span (`reads`).
Its clock is `time.time_ns()`, the clock of the harness's spans and the
one the device trace is mapped onto (`trace.read_events`).

Loading `spans/program.py`, which a traced run alone does, switches the
recorder on for the rest of the run; `program_spans` takes its records
once the run is over and marks each as in the window (its entry call
holds a span of the harness's in the window) or in the traced chunk (its
middle lies between the trace's markers). A program without the
recorder leaves nothing, and every reader here returns None.

Run as a module, it runs one traced cell like `run.py` and prints, after
the result line, a `program` line with what the `info` line does not
carry: the traced chunk's idle time by program span, branch reads by
span, the clock's lead and the step's split (see `main`):

    python3 -m slam_bench.program --workload <cell> --seed <n> --seconds <s> [--recorder 0]
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys

import numpy as np

from slam_bench.trace import busy_intervals

BLOCKS = ("step.bootstrap", "step.match", "step.motion", "step.map", "step.pose",
          "step.keyframe", "step.finish")
# The entry's children whose time is not the entry's own (`entry_ms.live`).
ENTRY_LAYERS = ("frontend", "track", "fuse")


@dataclasses.dataclass
class ProgramSpan:
    """One record of the program's recorder, as the readers see it."""

    name: str
    parent: int  # index of the enclosing span in the run's list, -1 at the top
    t0_ns: int
    t1_ns: int
    frames: int
    reads: int
    in_window: bool = False
    profiled: bool = False


def _taken() -> list:
    """The recorder's records, switched off and taken (none from a
    program without the recorder)."""
    prof = sys.modules.get("vslam_tpu_torch.utils.profiling")
    stop = getattr(prof, "stop_recording", None)
    if stop is None:
        return []
    return [ProgramSpan(r.name, r.parent, r.t0_ns, r.t1_ns, r.frames, r.reads) for r in stop()]


def mark(spans: list, harness: list, profile) -> list:
    """Marks `spans` in place: in the window when its top-level span holds
    the start of a harness span in the window, in the traced chunk when
    its middle lies between the trace's markers."""
    starts = np.sort(np.array([h.t0_ns for h in harness if h.in_window], np.int64))
    top = []
    for s in spans:
        root = s if s.parent < 0 else top[s.parent]
        top.append(root)
        if s.parent < 0:
            i = np.searchsorted(starts, s.t0_ns)
            s.in_window = bool(i < len(starts) and starts[i] <= s.t1_ns)
        else:
            s.in_window = root.in_window
        if profile:
            mid = (s.t0_ns + s.t1_ns) // 2
            s.profiled = bool(profile["span0"] <= mid <= profile["span1"])
    return spans


def program_spans(run) -> list:
    """The run's program spans, marked: taken from the recorder the first
    time and kept on the record (`run.program_spans`)."""
    spans = getattr(run, "program_spans", None)
    if spans is None:
        spans = mark(_taken(), run.spans, run.profile)
        run.program_spans = spans
    return spans


def self_ns(spans: list) -> list:
    """Each span's self time: its duration less the time its children
    cover (children of one span run one after another)."""
    out = [s.t1_ns - s.t0_ns for s in spans]
    for s in spans:
        if s.parent >= 0:
            out[s.parent] -= s.t1_ns - s.t0_ns
    return out


def window_frames(spans: list) -> int:
    """Frames of the window's entry calls (member-frames at B > 1)."""
    return sum(s.frames for s in spans if s.name == "entry" and s.parent < 0 and s.in_window)


def self_ms_per_frame(run, name: str):
    """Self time of the window's spans `name`, per frame of the window
    (0 where none opened)."""
    spans = program_spans(run)
    frames = window_frames(spans)
    if not frames:
        return None
    own = self_ns(spans)
    return sum(t for s, t in zip(spans, own) if s.in_window and s.name == name) / 1e6 / frames


def entry_ms_per_frame(run):
    """The window's entry calls less their `frontend`, `track` and `fuse`
    children (the copies in, the outputs' concatenation), per frame."""
    spans = program_spans(run)
    frames = window_frames(spans)
    if not frames:
        return None
    own = {i: s.t1_ns - s.t0_ns for i, s in enumerate(spans)
           if s.name == "entry" and s.parent < 0 and s.in_window}
    for s in spans:
        if s.parent in own and s.name in ENTRY_LAYERS:
            own[s.parent] -= s.t1_ns - s.t0_ns
    return sum(own.values()) / 1e6 / frames


def reads_by_span(run) -> dict:
    """Branch reads per frame of the window, by span name (None with
    nothing to read)."""
    spans = program_spans(run)
    frames = window_frames(spans)
    if not frames:
        return None
    reads = collections.Counter()
    for s in spans:
        if s.in_window and s.reads:
            reads[s.name] += s.reads
    return {k: v / frames for k, v in reads.most_common()}


def reads_per_frame(run):
    """Branch reads of the window, all spans, per frame."""
    by = reads_by_span(run)
    return None if by is None else sum(by.values())


def idle_by_program_span(run, top: int = 10):
    """The traced chunk's idle device time (s), each gap labelled by the
    innermost program span open at its middle ("outside" when none);
    the largest `top`."""
    p = run.profile
    spans = [s for s in program_spans(run) if s.profiled]
    if not p or not spans:
        return None
    bs, be = busy_intervals(p["start"], p["end"])
    gaps_s = np.concatenate([[p["span0"]], be])
    gaps_e = np.concatenate([bs, [p["span1"]]])
    keep = gaps_e > gaps_s
    gaps_s, gaps_e = gaps_s[keep], gaps_e[keep]
    mids = (gaps_s + gaps_e) // 2
    label = np.full(len(mids), "outside", dtype=object)
    width = np.full(len(mids), np.iinfo(np.int64).max)
    for s in spans:
        inside = (mids >= s.t0_ns) & (mids <= s.t1_ns) & (s.t1_ns - s.t0_ns < width)
        label[inside] = s.name
        width[inside] = s.t1_ns - s.t0_ns
    sums = collections.defaultdict(int)
    for lab, g in zip(label, gaps_e - gaps_s):
        sums[lab] += int(g)
    return sorted(([k, v / 1e9] for k, v in sums.items()), key=lambda r: -r[1])[:top]


def clock_leads_us(run):
    """Per marked span of the traced chunk, in the order they ran: the
    opening marker's device start (mapped onto the host's clock) less the
    span's host start, in us. A clock shared without error reads at least
    minus the first marker's launch latency, the mapping's error. Needs
    the markers' starts (`marker_start`, kept by `main`); None without
    them."""
    p = run.profile
    starts = p.get("marker_start") if p else None
    marked = [s for s in run.spans if s.profiled and s.kept is not None]
    if not starts or not marked or 2 * len(marked) != len(starts) - 2:
        return None
    # starts: the trace's first marker, each marked span's two, the last.
    return [(m - s.t0_ns) / 1e3 for s, m in zip(marked, starts[1:-1:2])]


def clock_lead_us(run):
    """The least of `clock_leads_us`."""
    leads = clock_leads_us(run)
    return min(leads) if leads else None


def step_split(run) -> dict:
    """Per frame of the window (ms): the program's `step` time, its own
    time, each block's self time and their sum, and `track` (the program's
    span) for `track_ms`."""
    spans = program_spans(run)
    frames = window_frames(spans)
    if not frames:
        return None
    own = self_ns(spans)
    out = {"step": sum(s.t1_ns - s.t0_ns for s in spans if s.in_window and s.name == "step")}
    for name in ("step",) + BLOCKS:
        out[name + ".self"] = sum(t for s, t in zip(spans, own) if s.in_window and s.name == name)
    out["blocks+self"] = sum(out[n + ".self"] for n in ("step",) + BLOCKS)
    out["track"] = sum(s.t1_ns - s.t0_ns for s in spans if s.in_window and s.name == "track")
    return {k: v / 1e6 / frames for k, v in out.items()}


def _keep_marker_starts(read_events):
    """`trace.read_events`, also keeping every marker's start on the
    host's clock (`marker_start`)."""
    def read(prof, mark0_host_ns):
        p = read_events(prof, mark0_host_ns)
        if p is not None:
            import torch

            from slam_bench.trace import MARKER_KERNEL, _start_ns

            cuda = torch.autograd.DeviceType.CUDA
            p["marker_start"] = sorted(_start_ns(e) - p["shift_ns"]
                                       for e in prof.profiler.kineto_results.events()
                                       if e.device_type() == cuda and MARKER_KERNEL in e.name())
        return p

    return read


def _ends(values):
    """The first, the median and the last of `values` (None for none)."""
    return None if not values else [values[0], float(np.median(values)), values[-1]]


def main(argv=None) -> int:
    """One traced run of a cell, as `run.py --trace 1` makes it, with the
    radius spans wrapped in every cell (their markers give the clock's
    lead), the marker kernel launched once before, and, with `--recorder
    0`, the program's recorder left off (the on/off comparison). Prints
    the result line, then `program <json>`."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--recorder", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    import torch

    from slam_bench import registry, run, trace

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    run.fixed_caches()
    # The marker kernel's first launch in a process loads its module (CUDA
    # loads kernels lazily), which would delay the trace's first marker,
    # the clock's anchor, by up to milliseconds.
    torch.cuda._sleep(1)
    torch.cuda.synchronize()
    spec = registry.cell(args.workload)
    spans = set(spec["spans"]) | {"radius_batched" if spec["traffic"]["streams"] > 1
                                  else "radius"}
    if not args.recorder:
        spans.discard("program")
    spec["spans"] = sorted(spans)
    seen = []
    reader = registry.reader

    def capturing(name, folder=None):
        read = reader(name, folder)

        def read_and_keep(rec):
            seen.append(rec)
            return read(rec)

        return read_and_keep

    registry.reader = capturing
    trace.read_events = _keep_marker_starts(trace.read_events)
    line = run.run_cell(spec, args.seed, args.seconds, True)
    rec = seen[-1]
    out = dict(cell=args.workload, seed=args.seed, recorder=args.recorder,
               idle_by_program_span=idle_by_program_span(rec), reads_by_span=reads_by_span(rec),
               clock_lead_us=clock_lead_us(rec), step_split=step_split(rec),
               clock_leads_us=_ends(clock_leads_us(rec)),
               program_spans=len(program_spans(rec)))
    print(json.dumps(line), flush=True)
    print("program " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
