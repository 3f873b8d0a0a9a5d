"""The readers of the program's own spans (`program.py`) on hand-made
records, the switch that a traced run alone throws (`spans/program.py`),
and the new per-layer entries of `BENCHMARK.json`."""

import numpy as np
import pytest

from slam_bench import program, registry, run, trace
from slam_bench.program import ProgramSpan
from slam_bench.trace import Span

MS = 1_000_000
NEW = {"match_ms": "step.match", "motion_ms": "step.motion", "map_ms": "step.map",
       "pose_ms": "step.pose", "keyframe_ms": "step.keyframe", "finish_ms": "step.finish",
       "keyframe_ms.live": "step.keyframe"}
RATE_CELLS = ["rgbd_sp640.offline", "mono_dn640.offline", "rgbd_sp640.streams4"]


@pytest.fixture
def recorder_off():
    from vslam_tpu_torch.utils import profiling

    profiling.stop_recording()
    yield profiling
    profiling.stop_recording()


def _spans(offset=0, in_window=True):
    """One entry call of 2 frames: copy 1 ms, frontend 2, track 10 (step
    4 + 5, blocks inside, pgo 1), fuse 1, and 1 ms of its own; reads on
    the blocks."""
    t = offset * MS

    def s(name, parent, a, b, frames=1, reads=0):
        return ProgramSpan(name, parent, t + a * MS, t + b * MS, frames, reads, in_window)

    return [
        s("entry", -1, 0, 15, frames=2),                                   # 0
        s("entry.copy", 0, 0, 1),                                          # 1
        s("frontend", 0, 1, 3, frames=2),                                  # 2
        s("track", 0, 3, 13, frames=2, reads=1),                           # 3
        s("step", 3, 3, 7, reads=1), s("step.bootstrap", 4, 3, 6, reads=1),     # 4, 5
        s("step", 3, 7, 12), s("step.match", 6, 7, 8, reads=1),                 # 6, 7
        s("step.motion", 6, 8, 9.5, reads=1), s("step.pose", 6, 9.5, 10),      # 8, 9
        s("step.map", 6, 10, 10.5), s("step.pose", 6, 10.5, 11, reads=1),      # 10, 11
        s("step.finish", 6, 11, 11.75),                                    # 12
        s("pgo", 3, 12, 13, reads=2),                                      # 13
        s("fuse", 0, 13, 14, frames=2),                                    # 14
    ]


def _record(spans, harness=(), profile=None):
    rec = run.Record(calls=[], streams=1, calls_per_sequence=1, setup_s=1.0)
    rec.spans, rec.profile = list(harness), profile
    if spans is not None:
        rec.program_spans = spans
    return rec


def test_self_time_is_the_duration_less_the_children():
    own = program.self_ns(_spans())
    assert own[0] == 1 * MS  # 15 less copy 1, frontend 2, track 10, fuse 1
    assert own[3] == 0  # 10 less the steps 4 + 5 and pgo 1
    assert own[4] == 1 * MS and own[6] == 0.25 * MS
    assert own[7] == 1 * MS and own[9] + own[11] == 1 * MS


def test_each_new_reader_on_a_known_record():
    # A second call outside the window counts for nothing.
    late = [ProgramSpan(s.name, s.parent + 15 if s.parent >= 0 else -1, s.t0_ns, s.t1_ns,
                        s.frames, s.reads, False) for s in _spans(offset=100)]
    rec = _record(_spans() + late)
    got = {name: registry.reader(name)(rec) for name in list(NEW) + ["entry_ms.live",
                                                                     "branch_reads_per_frame"]}
    assert got == pytest.approx({
        "match_ms": 0.5, "motion_ms": 0.75, "map_ms": 0.25, "pose_ms": 0.5,
        "keyframe_ms": 0.0, "keyframe_ms.live": 0.0, "finish_ms": 0.375,
        "entry_ms.live": 1.0,  # entry less frontend, track, fuse: copy 1 + own 1, 2 frames
        "branch_reads_per_frame": 4.0})
    assert program.reads_by_span(rec) == {"pgo": 1.0, "track": 0.5, "step": 0.5,
                                          "step.bootstrap": 0.5, "step.match": 0.5,
                                          "step.motion": 0.5, "step.pose": 0.5}
    split = program.step_split(rec)
    assert split["step"] == pytest.approx(4.5) and split["track"] == pytest.approx(5.0)
    assert split["blocks+self"] == pytest.approx(split["step"])


def test_readers_read_nothing_without_program_spans(recorder_off):
    for spans in ([], None):  # none recorded; a recorder that is off gives none
        rec = _record(spans)
        for name in list(NEW) + ["entry_ms.live", "branch_reads_per_frame"]:
            assert registry.reader(name)(rec) is None, name
        assert program.idle_by_program_span(rec) is None
        assert program.clock_lead_us(rec) is None and program.step_split(rec) is None


def test_a_program_without_the_recorder_reads_nothing(recorder_off, monkeypatch):
    """An older program (no `start_recording`, no `stop_recording`): the
    span file loads and switches nothing, and the readers find nothing."""
    monkeypatch.delattr(recorder_off, "start_recording")
    monkeypatch.delattr(recorder_off, "stop_recording")
    trace.span_defs({"program"})
    rec = _record(None, [Span("frontend", 0, MS, 1, True, False)])
    assert registry.reader("match_ms")(rec) is None and rec.program_spans == []


def test_calls_are_marked_in_the_window_by_the_harness_spans_they_hold():
    spans = [ProgramSpan(s.name, s.parent, s.t0_ns, s.t1_ns, s.frames, s.reads)
             for s in _spans()]
    later = [ProgramSpan(s.name, s.parent + 15 if s.parent >= 0 else -1, s.t0_ns + 20 * MS,
                         s.t1_ns + 20 * MS, s.frames, s.reads) for s in spans]
    harness = [Span("frontend", 1 * MS + 10, 3 * MS - 10, 2, True, False),
               Span("frontend", 21 * MS + 10, 23 * MS - 10, 2, False, True)]
    profile = dict(span0=20 * MS, span1=35 * MS)
    marked = program.mark(spans + later, harness, profile)
    assert all(s.in_window and not s.profiled for s in marked[:15])
    assert all(s.profiled and not s.in_window for s in marked[15:])


def test_idle_gaps_take_the_innermost_program_span_and_the_clock_lead():
    spans = _spans()
    for s in spans:
        s.profiled = True
    ns = MS
    # Busy [0.5, 1) and [7.2, 7.4) ms: gaps [-1, 0.5) outside the call
    # (the chunk starts before the entry), [1, 7.2) in the bootstrap at
    # its middle 4.1, [7.4, 16) in the finish at its middle 11.7.
    profile = dict(start=np.array([0.5, 7.2]) * ns, end=np.array([1.0, 7.4]) * ns,
                   span0=-1 * ns, span1=16 * ns, marked=[(1, 2)],
                   marker_start=[-1 * ns, 7.1 * ns, 7.5 * ns, 16 * ns])
    kept = dict(D=256)
    harness = [Span("radius", int(7.05 * ns), int(7.6 * ns), 1, False, True, kept, False)]
    rec = _record(spans, harness, profile)
    gaps = dict(program.idle_by_program_span(rec))
    assert gaps == pytest.approx({"step.bootstrap": 0.0062, "step.finish": 0.0086,
                                  "outside": 0.0015})
    assert program.clock_lead_us(rec) == pytest.approx(50.0)
    profile["marker_start"] = profile["marker_start"][:3]  # a marker short: no reading
    assert program.clock_lead_us(rec) is None


def test_only_a_traced_run_switches_the_recorder_on(recorder_off):
    assert recorder_off.span("a") is recorder_off.span("b")
    hooks = trace.Hooks(False, 32, 32, ["program", "frontend"])
    hooks.remove()
    assert recorder_off.span("a") is recorder_off.span("b")
    hooks = trace.Hooks(True, 32, 32, ["program"])
    hooks.remove()
    with recorder_off.span("step") as rec:
        pass
    assert rec.name == "step" and recorder_off.stop_recording() == [rec]


def test_the_new_entries_resolve_in_the_cells_they_name():
    bench = registry.benchmark()
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in list(NEW) + ["entry_ms.live", "branch_reads_per_frame"]:
        m = per_layer[name]
        live = name.endswith(".live")
        assert m["workloads"] == (["rgbd_sp640.live"] if live else RATE_CELLS)
        assert m["moves"] == ("frame_ms_p95" if live else "fps")
        assert m["source"] == ("program_counter" if name == "branch_reads_per_frame"
                               else "program_span")
        mod = registry._module(name)
        assert callable(mod.read) and "program" in mod.SPANS
    for cell in [w["name"] for w in bench["workloads"]]:
        spec = registry.cell(cell)
        assert "program" in spec["spans"]
        mine = {m["name"] for m in spec["per_layer"]} & (set(NEW) | {"entry_ms.live",
                                                                   "branch_reads_per_frame"})
        assert mine == ({"keyframe_ms.live", "entry_ms.live"} if cell == "rgbd_sp640.live"
                        else set(NEW) - {"keyframe_ms.live"} | {"branch_reads_per_frame"})
