"""The harness end to end on the CPU at a tiny size (the program's plain
kernel versions), the faults its check has to catch, and what a run may
and may not do."""

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from slam_bench import check, readers, registry, run, study
from slam_bench.trace import Span, busy_intervals, idle_by_span, short_name

CPU = torch.device("cpu")


def test_a_tiny_run_prints_the_result_line(tiny_spec):
    spec = tiny_spec("rgbd_sp640.offline", frames=16)
    line = run.run_cell(spec, 2**31 + 12345, 0.5, False, device="cpu", workers=2)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["attempted"] >= 16 and line["failed"] >= 0
    assert set(line["metrics"]) == {"fps", "ate_m", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["device"]["platform"] == "cpu"
    assert set(line["checks"]) == set(spec["limits"])
    assert line["checks"]["cloud_diff"]["value"] == 0
    json.loads(json.dumps(line, allow_nan=False))


def test_a_live_run_times_every_frame(tiny_spec):
    spec = tiny_spec("rgbd_sp640.live", frames=16)
    # A window that holds the whole sequence at up to 0.25 s a frame.
    line = run.run_cell(spec, 7, 4.0, False, device="cpu", workers=2)
    assert set(line["metrics"]) >= {"frame_ms_p95", "setup_s"}
    assert line["attempted"] >= 16


@pytest.mark.parametrize("cell", ["rgbd_sp640.offline", "rgbd_sp640.streams4",
                                  "mono_dn640.offline"])
def test_each_fault_makes_the_check_fail(cell, tiny_spec):
    """Limits at twice the sound run's readings (the small world tracks
    worse than the cell's): the sound run passes, each fault fails."""
    spec = tiny_spec(cell, frames=32, scale=2)
    sound, _ = study.one_sequence(spec, 0, CPU, workers=2)
    limits = {k: (0 if k == "cloud_diff" else 2 * v) for k, v in sound.items()}
    assert check.judge(sound, limits), sound
    for fault in study.faults_of(spec["traffic"]["streams"]):
        got, _ = study.one_sequence(spec, 0, CPU, fault, workers=2, altered_m=1.0)
        assert not check.judge(got, limits), (fault, got)


def test_a_nested_span_outside_the_traced_chunk_neither_syncs_nor_records(monkeypatch):
    from vslam_tpu_torch.ops import matching

    from slam_bench.trace import Hooks

    def match(desc_q, uv_q, valid_q, desc_db, uv_db, valid_db, radius_px, desc_thresh):
        return "matched"

    monkeypatch.setattr(matching, "radius_descriptor_match_fused", match)
    hooks = Hooks(True, 32, 32, ["radius"])
    try:
        # On a machine without CUDA a sync would raise.
        assert matching.radius_descriptor_match_fused(1, 2, 3, 4, 5, 6, 7.0, 0.7) == "matched"
        assert hooks.spans == []
    finally:
        hooks.remove()
    assert matching.radius_descriptor_match_fused is match


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_configured_precision_is_the_one_loaded(dtype, tiny_spec):
    from slam_bench.system import System

    spec = tiny_spec("mono_dn640.offline", frames=8)
    spec["config"]["superpoint_dtype"] = spec["config"]["depthnet_dtype"] = dtype
    system = System(spec["config"], spec["traffic"], device=CPU, workers=1)
    assert system.model.compute_dtype == getattr(torch, dtype)
    assert system.depth_model.compute_dtype == getattr(torch, dtype)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "vslam_tpu_torch_extra", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "vslam_tpu.config", object())
    assert run.forbidden_modules() == ["vslam_tpu"]


def test_a_run_loads_no_jax_and_no_jax_package():
    code = ("import sys; sys.path.insert(0, 'slam_bench/tests'); from conftest import tiny; "
            "from slam_bench import run; run.run_cell(tiny('mono_dn640.offline', frames=16), 1, "
            "0.1, False, device='cpu', workers=1); print('FOUND', run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert "FOUND []" in out.stdout, out.stderr[-2000:]


def test_without_a_card_it_fails_and_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "rgbd_sp640.offline", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_alone_in_a_directory_it_fails_and_prints_no_result(tmp_path):
    shutil.copy(registry.BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(registry.HERE, tmp_path / "slam_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = subprocess.run([sys.executable, "-m", "slam_bench.run", "--workload",
                          "rgbd_sp640.offline", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def _record(spans, profile, frames=2):
    rec = run.Record(calls=[], streams=1, calls_per_sequence=1, setup_s=1.0)
    rec.spans, rec.profile, rec.profile_frames, rec.flops_per_frame = spans, profile, frames, 1e9
    return rec


def test_trace_readers_on_a_known_record():
    ns = 1_000_000
    profile = dict(names=["a", "radius_match_kernel", "a"],
                   start=np.array([1, 4, 5]) * ns, end=np.array([3, 5, 6]) * ns,
                   span0=0, span1=10 * ns, marked=[(1, 2)])
    kept = dict(uv_q=np.zeros((4, 2), np.float32), valid_q=np.ones(4, bool),
                uv_db=np.zeros((8, 2), np.float32), valid_db=np.ones(8, bool), D=256,
                radius_px=12.0)
    spans = [Span("track", 0, 10 * ns, 2, False, True),
             Span("radius", 4 * ns - 1000, 5 * ns - 1000, 1, False, True, kept),
             Span("track", 0, 4 * ns, 2, True, False)]
    rec = _record(spans, profile)
    assert readers.idle_share(rec) == pytest.approx(60.0)
    assert readers.kernels_per_frame(rec) == 1.5
    assert readers.frame_mfu(rec) == pytest.approx(100 * 2e9 / 0.01 / 989e12)
    from slam_bench.frozen import radius_work as rw

    w = rw.radius_work(**kept)
    assert readers.radius_roofline(rec, "radius") == pytest.approx(
        100 * rw.bound_s(w["nbytes"], w["flops"]) / 1e-3)
    assert readers.span_ms_per_frame(rec, "track") == pytest.approx(2.0)
    assert readers.span_ms_per_frame(rec, "fuse") is None
    gaps = dict(idle_by_span(profile, spans))
    assert gaps["track"] == pytest.approx(0.006)
    s, e = busy_intervals(np.array([5, 0, 1]), np.array([6, 2, 3]))
    assert s.tolist() == [0, 5] and e.tolist() == [3, 6]


def test_readers_read_nothing_from_an_untraced_record():
    rec = _record([], None, 0)
    for name in ("idle_share", "kernels_per_frame", "frame_mfu", "radius_roofline",
                 "frontend_ms", "host_syncs_per_frame"):
        assert registry.reader(name)(rec) is None


def test_kernel_names_lose_their_template_arguments():
    assert short_name("void at::native::vectorized_elementwise_kernel<4, at::native::"
                      "CUDAFunctor_add<float>, std::array<char*, 3ul> >(int)") == \
        "at::native::vectorized_elementwise_kernel<CUDAFunctor_add>"
    assert short_name("radius_match_kernel") == "radius_match_kernel"


@pytest.mark.gpu
def test_a_traced_run_on_the_card_reads_every_per_layer_metric():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for cell in ("rgbd_sp640.offline", "rgbd_sp640.live"):
        spec = registry.cell(cell)
        line = run.run_cell(spec, 3, 1.0, True, device="cuda")
        assert set(line["metrics"]) == {m["name"] for m in spec["per_layer"]}, cell
        assert 0 < line["device"]["busy_s"] < line["device"]["window_s"]


def test_trace_events_between_markers_map_to_the_host_clock():
    from types import SimpleNamespace

    from slam_bench.trace import read_events

    cuda = torch.autograd.DeviceType.CUDA

    def ev(start, dur, name, dev=cuda):
        return SimpleNamespace(start_ns=lambda: start, duration_ns=lambda: dur,
                               name=lambda: name, device_type=lambda: dev)

    evs = [ev(50, 5, "primer"), ev(100, 10, "spin_kernel"), ev(120, 5, "k1"),
           ev(130, 1, "spin_kernel"), ev(140, 20, "radius_match_kernel"), ev(161, 2, "copy"),
           ev(170, 1, "spin_kernel"), ev(180, 5, "k2"), ev(200, 10, "spin_kernel"),
           ev(105, 3, "host op", torch.autograd.DeviceType.CPU)]
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(
        events=lambda: evs)))
    p = read_events(prof, mark0_host_ns=90)
    assert p["names"] == ["k1", "radius_match_kernel", "copy", "k2"]
    assert p["marked"] == [(1, 3)]
    assert p["start"].tolist() == [110, 130, 151, 170] and p["span0"] == 100
    assert p["span1"] == 190
    assert read_events(SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(
        events=lambda: evs[2:]))), 90) is None
