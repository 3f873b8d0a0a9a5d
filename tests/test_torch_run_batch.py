"""`vslam_tpu_torch.apps.run_batch` against the JAX package's
`examples/run_batch.py`, and `apps.bench_batched_step`, on the CPU.

Both runners take a 4-frame TUM directory (the tiny camera, SuperPoint
features in f32 in both frameworks, `descriptor_dim` 256) and one
synthetic fill sequence, on a 2-device mesh (JAX: 2 virtual CPU devices;
the port: 2 CPU ranks); each sequence's ATE is held within 1e-5 m of
JAX's (the JAX script prints 4 decimals, so its `compute_ate` results are
recorded directly).
"""

import contextlib
import dataclasses
import functools
import importlib.util
import io
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)


def _cfg(tiny):
    t = tiny()
    return t.replace(frontend=dataclasses.replace(t.frontend, descriptor_dim=256))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from vslam_tpu_torch.config import tiny_test_config
    from vslam_tpu_torch.data import synthetic

    c = _cfg(tiny_test_config).camera
    seq = synthetic.make_room_sequence(num_frames=4, seed=1, max_keypoints=64, desc_dim=256,
                                       width=c.width, height=c.height, fx=c.fx, fy=c.fy,
                                       cx=c.cx, cy=c.cy)
    root = str(tmp_path_factory.mktemp("tum") / "room4")
    synthetic.write_tum_sequence(root, seq)
    return root


def _run_jax(argv):
    import vslam_tpu.config as j_config
    import vslam_tpu.eval.ate as j_ate
    import vslam_tpu.models.superpoint as j_sp
    from vslam_tpu.config import tiny_test_config

    spec = importlib.util.spec_from_file_location(
        "jax_run_batch", os.path.join(ROOT, "examples", "run_batch.py"))
    app = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(app)
    cfg, ates = _cfg(tiny_test_config), []
    compute_ate = j_ate.compute_ate

    def record(*a, **k):
        res = compute_ate(*a, **k)
        ates.append(float(res.rmse))
        return res

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_config, "SlamConfig", lambda: cfg)
        mp.setattr(j_sp, "SuperPoint", functools.partial(j_sp.SuperPoint,
                                                         compute_dtype=jnp.float32))
        mp.setattr(j_ate, "compute_ate", record)
        mp.setattr(sys, "argv", ["run_batch.py"] + argv)
        with contextlib.redirect_stdout(io.StringIO()):
            app.main()
    return ates


def _run_port(argv):
    from vslam_tpu_torch.apps import run_batch
    from vslam_tpu_torch.config import tiny_test_config
    from vslam_tpu_torch.models import weights

    load = weights.load_superpoint
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(weights, "load_superpoint",
                   lambda *a, **k: load(*a, **{**k, "compute_dtype": torch.float32}))
        return run_batch.run(run_batch.parse_args(argv), _cfg(tiny_test_config))


def test_run_batch_matches_jax(dataset):
    argv = [dataset, "--devices", "2", "--cpu", "--frames", "4", "--frame-step", "1"]
    want = _run_jax(argv)
    got = _run_port(argv)
    assert got["devices"] == 2 and got["frames"] == 8 and got["frames_per_s"] > 0
    assert list(got["ate_rmse_m"]) == ["room4", "synthetic-1"]
    np.testing.assert_allclose(list(got["ate_rmse_m"].values()), want, atol=1e-5, rtol=0)


def test_bench_batched_step_runs_to_its_end():
    from vslam_tpu_torch.apps import bench_batched_step as bb
    from vslam_tpu_torch.config import tiny_test_config

    out = bb.run(bb.parse_args(["--cpu", "--n", "2", "--b", "2", "--bs", "1,2,4"]),
                 tiny_test_config())
    names = list(out["us_per_iter"])
    assert names[:2] == ["full batched step B=1 (threaded)", "full batched step B=2 (threaded)"]
    assert len(names) == 11 and all(v > 0 for v in out["us_per_iter"].values())
    assert out["launches_per_iter"] == dict.fromkeys(names)  # no card: nothing to count
    assert len(out["map_rows"]) == 2 and min(out["map_rows"]) > 0


def test_entry_points_need_a_card(monkeypatch, dataset):
    from vslam_tpu_torch.apps import bench_batched_step, run_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_batch.main([dataset, "--frames", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_batched_step.main(["--n", "1", "--b", "1"])


@pytest.mark.slow
def test_run_batch_full_size_vs_jax(tmp_path):
    """The smoke's `run_batch` reference: both runners on the seed-0 room
    world (96 frames, 640x480, the app phase's directory) at the default
    `SlamConfig`, `--devices 1 --frames 64 --frame-step 3`. Prints JAX's
    ATE (`RUN_BATCH_JAX` in `chip_smoke.py`) and the port's on the CPU;
    the port within twice JAX's, at least 0.02 m (the smoke's limit)."""
    import vslam_tpu.eval.ate as j_ate
    from vslam_tpu_torch.apps import run_batch
    from vslam_tpu_torch.config import SlamConfig
    from vslam_tpu_torch.data import synthetic

    root = str(tmp_path / "room96")
    synthetic.write_tum_sequence(root, synthetic.make_room_sequence(num_frames=96, seed=0))
    argv = [root, "--devices", "1", "--cpu", "--frames", "64", "--frame-step", "3"]
    spec = importlib.util.spec_from_file_location(
        "jax_run_batch", os.path.join(ROOT, "examples", "run_batch.py"))
    app = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(app)
    ates = []
    compute_ate = j_ate.compute_ate
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_ate, "compute_ate",
                   lambda *a, **k: ates.append(compute_ate(*a, **k)) or ates[-1])
        mp.setattr(sys, "argv", ["run_batch.py"] + argv)
        app.main()
    got = run_batch.run(run_batch.parse_args(argv), SlamConfig())
    print(f"RUN_BATCH_JAX = {float(ates[0].rmse):.6f}  port on the CPU "
          f"{got['ate_rmse_m']['room96']:.6f}")
    assert got["ate_rmse_m"]["room96"] <= max(2 * float(ates[0].rmse), 0.02)
