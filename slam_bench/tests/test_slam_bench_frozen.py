"""The benchmark's frozen copies agree with the originals they were
copied from, at one shape each."""

import numpy as np
import pytest

from slam_bench.frozen import flops, generator, radius_work

CAM = (120.0, 120.0, 79.5, 59.5, 160, 120)


@pytest.mark.parametrize("radii", [(3.0, 3.0), (3.0, 2.0)])
def test_generator_is_the_ports_bit_for_bit(radii):
    from vslam_tpu_torch.data import synthetic

    n = 6
    got = generator.make_worlds([5, 9], n, CAM, num_landmarks=700, radii=radii, workers=1)
    for w, seed in enumerate([5, 9]):
        want = synthetic.make_image_sequence(
            n, width=160, height=120, fx=120.0, fy=120.0, cx=79.5, cy=59.5,
            seed=seed, num_landmarks=700, radius=radii[w], with_rgb=False)
        np.testing.assert_array_equal(got["gray"][w], want["gray"])
        np.testing.assert_array_equal(got["depth_u16"][w], want["depth_u16"])
        np.testing.assert_array_equal(got["timestamps"], want["timestamps"])
        for k in ("R", "t"):
            np.testing.assert_array_equal(got[k][w], want[k])


def test_generator_renders_the_same_in_worker_processes():
    one = generator.make_worlds([3, 4], 4, CAM, num_landmarks=500, radii=(3.0, 2.5), workers=1)
    two = generator.make_worlds([3, 4], 4, CAM, num_landmarks=500, radii=(3.0, 2.5), workers=2)
    for k in one:
        np.testing.assert_array_equal(one[k], two[k])


def test_flops_are_the_ports():
    from vslam_tpu_torch.utils import flops as port

    assert flops.superpoint_flops_per_frame(480, 640) == port.superpoint_flops_per_frame(480, 640)
    assert flops.depthnet_flops_per_frame(240, 320) == port.depthnet_flops_per_frame(240, 320)
    assert (flops.tracking_flops_per_frame(400, 256, 16384)
            == port.tracking_flops_per_frame(400, 256, 16384))


def test_radius_work_is_the_smokes():
    import chip_smoke

    rng = np.random.default_rng(0)
    for B in (None, 3):
        lead = () if B is None else (B,)
        uq = rng.uniform(0, 200, lead + (50, 2)).astype(np.float32)
        ud = rng.uniform(0, 200, lead + (300, 2)).astype(np.float32)
        vq = rng.random(lead + (50,)) < 0.8
        vd = rng.random(lead + (300,)) < 0.5
        assert radius_work.radius_work(uq, vq, ud, vd, 256, 12.0) == chip_smoke.radius_work(
            uq, vq, ud, vd, 256, 12.0)
    assert radius_work.bound_s(3.35e9, 0) == pytest.approx(chip_smoke.bound(3.35e9, 0)[0] / 1e3)
