"""The port's profiling and FLOP utilities (`vslam_tpu_torch.utils`)
against the JAX package's (`vslam_tpu.utils`): the FLOP models equal for
the same shapes (and the DepthNet model equal to a count over the port's
own layer shapes), the run summaries and per-frame logs equal on the same
outputs, the stage timer's report, and a CPU trace written by
`device_trace`.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vslam_tpu.utils import flops as j_flops
from vslam_tpu.utils import profiling as j_prof
from vslam_tpu_torch.models import depthnet as t_dn
from vslam_tpu_torch.utils import flops as t_flops
from vslam_tpu_torch.utils import profiling as t_prof


@pytest.mark.parametrize("hw", [(480, 640), (120, 160), (64, 80)])
def test_flop_models_equal(hw):
    assert t_flops.superpoint_flops_per_frame(*hw) == j_flops.superpoint_flops_per_frame(*hw)
    assert (t_flops.superpoint_train_step_flops(16, *hw)
            == 3 * 2 * 16 * j_flops.superpoint_flops_per_frame(*hw))
    for k, d, m in ((400, 256, 16384), (64, 32, 1024)):
        assert t_flops.tracking_flops_per_frame(k, d, m) == j_flops.tracking_flops_per_frame(k, d, m)


def test_depthnet_flops_count_the_layers(monkeypatch):
    """2 * Cin * Cout * 9 per output pixel of every convolution the port's
    DepthNet runs at 240x320 (the training input)."""
    model = t_dn.DepthNet(compute_dtype=torch.float32, device="cpu")
    total = []
    conv2d = torch.nn.functional.conv2d

    def counting(x, w, *a, **k):
        y = conv2d(x, w, *a, **k)
        total.append(2 * w.shape[1] * w.shape[0] * w.shape[2] * w.shape[3] * y.shape[-2] * y.shape[-1])
        return y

    monkeypatch.setattr(t_dn.F, "conv2d", counting)
    with torch.no_grad():
        model(torch.zeros(1, 240, 320, 1))
    assert len(total) == 8
    assert t_flops.depthnet_flops_per_frame(240, 320) == float(sum(total))
    assert t_flops.depthnet_train_step_flops(8, 240, 320) == 3 * 8 * float(sum(total))


def _outputs(n=12, seed=0):
    rng = np.random.default_rng(seed)
    o = dict(num_matches=rng.integers(0, 80, n), num_inliers=rng.integers(0, 60, n),
             num_tracked=rng.integers(0, 90, n), is_keyframe=rng.random(n) > 0.7,
             used_3d3d=rng.random(n) > 0.2, tracking_ok=rng.random(n) > 0.1,
             bridged=rng.random(n) > 0.8, recovered=rng.random(n) > 0.9,
             epi_before=np.where(rng.random(n) > 0.3, rng.random(n), 0.0).astype(np.float32),
             epi_after=rng.random(n).astype(np.float32))
    return (SimpleNamespace(**o),
            SimpleNamespace(**{k: torch.from_numpy(np.asarray(v)) for k, v in o.items()}))


def test_summaries_equal_jax(tmp_path):
    o_np, o_t = _outputs()
    assert t_prof.summarize_run(o_t) == j_prof.summarize_run(o_np)
    rows = t_prof.step_metrics_log(o_t, str(tmp_path / "p.jsonl"))
    assert rows == j_prof.step_metrics_log(o_np, str(tmp_path / "j.jsonl"))
    assert (tmp_path / "p.jsonl").read_text() == (tmp_path / "j.jsonl").read_text()
    o_np.epi_before = np.zeros(12, np.float32)
    o_t.epi_before = torch.zeros(12)
    assert t_prof.summarize_run(o_t) == j_prof.summarize_run(o_np)


def test_stage_timer_and_trace(tmp_path):
    timer = t_prof.StageTimer()
    for _ in range(3):
        with timer.stage("mul") as box:
            box["result"] = (torch.ones(64, 64) @ torch.ones(64, 64),)
    with timer.stage("idle"):
        pass
    assert timer.counts == {"mul": 3, "idle": 1}
    lines = timer.report().splitlines()
    assert len(lines) == 2 and "x3" in " ".join(lines)
    x = {"a": [torch.ones(3)]}
    assert t_prof.force_completion(x) is x
    with t_prof.device_trace(str(tmp_path / "tr")):
        torch.ones(128, 128) @ torch.ones(128, 128)
    with open(tmp_path / "tr" / "trace.json") as f:
        assert json.load(f)["traceEvents"]


@pytest.mark.parametrize("sessions,want,calls", [
    # (the device records of each session, in start order: p a primer, m a
    # marker, k the call's; the count `device_activities` gives; the calls
    # of fn it makes)
    ([["p", "p", "m", "k", "k", "k", "m"]], 3, 1),
    ([["p", "k", "m"], ["p", "p", "m", "k", "m"]], 1, 2),  # the first marker lost
    ([["m", "k"], ["m", "k", "k", "m"]], 2, 2),            # the last marker lost
    ([[], [], []], None, 3),                               # no whole session: no count
])
def test_device_activities_retries_a_session_without_its_markers(monkeypatch, sessions, want,
                                                                 calls):
    """`device_activities` counts the records between a session's two
    markers (not the primers before them), runs the call again when a
    marker is missing (up to three sessions), and counts the sessions."""
    left = [[t_prof.MARKER_KERNEL if n == "m" else "kernel" for n in s] for s in sessions]

    def fake_session(fn, pad_s=t_prof.EDGE_PAD_S):
        fn()
        return left.pop(0)

    monkeypatch.setattr(t_prof, "framed_session", fake_session)
    monkeypatch.setattr(t_prof, "SESSIONS", {"whole": 0, "lost": 0})
    n = []
    got = t_prof.device_activities(lambda: n.append(1), torch.device("cuda"))
    assert got == want and len(n) == calls
    assert t_prof.SESSIONS == {"whole": int(want is not None), "lost": calls - (want is not None)}
    assert t_prof.device_activities(lambda: n.append(1), torch.device("cpu")) is None
