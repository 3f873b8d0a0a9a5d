"""Depth Anything V2 Small (`vslam_tpu_torch.models.depth_anything`) on the
CPU, at the published widths on tiny frames (42x56 with the resize's
lower bound at 42: 3x4 patches, 13 tokens), with seeded random weights.

- Against the plain f32 reference (`slam_bench/reference/depth_anything.py`,
  which imports nothing of the port): in f32 within 1e-5 in log depth
  (measured 2.4e-7); in bf16 within `BF16_LOG_TOL` = 5e-4 (measured
  1.0e-4), a tolerance the reference computed with fp8 (e4m3) inputs and
  weights fails (measured 1.9e-3).
- The position embedding on a non-square grid (two f32 products) against
  the reference's `F.interpolate` and a numpy bicubic written from the
  published call (scale factors (g + 0.1) / 37, a = -0.75, clamped taps).
- Keypoint depth equals resizing the map to the frame's size and picking
  the rounded pixel, to float32 rounding (the resize's kernel may contract
  its products into FMAs: a few ulps).
- The state dict's names and shapes are `PARAM_SHAPES`, the published
  checkpoint's; the bf16 checkpoint round trip.
- `core.frontend.predicted_keypoint_depth` with DepthNet gives the direct
  `depthnet` calls' depth bit for bit; with this network its own
  `keypoint_depth`, in the program span `frontend.depth` with its tokens
  counted, without a host read; a tiny monocular `run_coupled` takes it.
- The committed checkpoint is a trained one; one training step at tiny
  size lowers the loss.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from slam_bench import da2_flops
from slam_bench.reference import depth_anything as ref
from slam_bench.reference.frontend import fp8_quant
from vslam_tpu_torch.config import tiny_test_config
from vslam_tpu_torch.core import coupled, frontend
from vslam_tpu_torch.core.state import init_state
from vslam_tpu_torch.data import synthetic
from vslam_tpu_torch.models import depth_anything as da
from vslam_tpu_torch.models import depthnet
from vslam_tpu_torch.models import train_depth_anything as tda
from vslam_tpu_torch.models import weights
from vslam_tpu_torch.ops import gridhash, prng
from vslam_tpu_torch.utils import flops, profiling

SIZE = 42  # the resize's lower bound in these tests: 42x56 stays 42x56
BF16_LOG_TOL = 5e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return da.init_params(seed=1)


@pytest.fixture(scope="module")
def frames():
    g = torch.Generator().manual_seed(0)
    return torch.randint(0, 256, (2, 42, 56), dtype=torch.uint8, generator=g)


def _model(params, dtype):
    m = da.DepthAnythingV2(compute_dtype=dtype, device="cpu", input_size=SIZE)
    m.load_state_dict(params)
    return m.eval()


def _reference(params, gray, quant=None):
    return ref.depth_map(dict(params), gray, quant, SIZE)


def test_input_shape_and_flops_at_the_published_size():
    assert da.input_shape(480, 640) == (518, 686) == da2_flops.input_shape(480, 640)
    assert da.input_shape(42, 56, SIZE) == (42, 56)
    assert flops.depth_anything_flops_per_frame(518, 686) == pytest.approx(
        da2_flops.flops_per_frame(480, 640), rel=1e-12)
    assert da2_flops.flops_per_frame(480, 640) == pytest.approx(167.465e9, rel=1e-5)


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5), (torch.bfloat16, BF16_LOG_TOL)])
def test_port_matches_the_plain_reference(params, frames, dtype, tol):
    with torch.no_grad():
        got = _model(params, dtype)(frames.float() / 255.0)
    want = _reference(params, frames)
    assert got.shape == want.shape == (2, 42, 56) and got.dtype == torch.float32
    assert float((got.log() - want.log()).abs().max()) <= tol


def test_an_fp8_rounding_fails_the_bf16_tolerance(params, frames):
    want = _reference(params, frames)
    control = _reference(params, frames, fp8_quant)
    assert float((control.log() - want.log()).abs().max()) > BF16_LOG_TOL


def _bicubic_1d(n_in, n_out, scale, a=-0.75):
    """(n_out, n_in) weights of torch's bicubic with a given scale factor:
    source x = (i + 0.5) / scale - 0.5, taps clamped into the input."""
    def w(t):
        t = abs(t)
        if t <= 1:
            return (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1
        if t < 2:
            return a * t ** 3 - 5 * a * t ** 2 + 8 * a * t - 4 * a
        return 0.0

    m = np.zeros((n_out, n_in))
    for i in range(n_out):
        x = (i + 0.5) / scale - 0.5
        x0 = int(np.floor(x))
        for k in range(-1, 3):
            m[i, min(max(x0 + k, 0), n_in - 1)] += w(x - (x0 + k))
    return m


@pytest.mark.parametrize("gh, gw", [(3, 4), (37, 49)])
def test_position_embedding_on_a_non_square_grid(params, gh, gw):
    pe = params["pretrained.pos_embed"]
    got = da.interpolate_pos_encoding(pe, gh, gw)
    assert got.shape == (1, 1 + gh * gw, da.WIDTH)
    torch.testing.assert_close(got, ref.position_embedding(pe, gh, gw), rtol=0, atol=1e-6)
    table = pe[0, 1:].reshape(37, 37, -1).double().numpy()
    mh = _bicubic_1d(37, gh, (gh + 0.1) / 37)
    mw = _bicubic_1d(37, gw, (gw + 0.1) / 37)
    want = np.einsum("ia,jb,abc->ijc", mh, mw, table).reshape(gh * gw, -1)
    np.testing.assert_allclose(got[0, 1:].double().numpy(), want, atol=2e-6, rtol=0)
    assert torch.equal(got[0, 0], pe[0, 0])
    assert da.interpolate_pos_encoding(pe, 37, 37) is pe  # the pretraining grid as it is


def test_keypoint_depth_equals_resize_then_pick(params, frames):
    m = _model(params, torch.float32)
    g = torch.Generator().manual_seed(3)
    xy = torch.rand(2, 64, 2, generator=g) * torch.tensor([55.0, 41.0])
    xy[0, :4] = torch.tensor([[0.0, 0.0], [55.0, 41.0], [2.5, 3.5], [-3.0, 60.0]])
    got = m.keypoint_depth(frames, xy)
    with torch.no_grad():
        depth = m(frames.float() / 255.0)
    full = F.interpolate(depth[:, None], size=(42, 56), mode="bilinear", align_corners=True)[:, 0]
    want = frontend.sample_depth_at_keypoints(full, xy)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    torch.testing.assert_close(got, ref.depth_at(dict(params), frames, xy, None, SIZE),
                               rtol=1e-5, atol=0)


def test_state_dict_names_and_shapes_are_the_published_ones(params, tmp_path):
    m = _model(params, torch.bfloat16)
    sd = m.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == da.PARAM_SHAPES
    assert sum(int(np.prod(s)) for s in da.PARAM_SHAPES.values()) == 24_785_089
    for key, shape in [
        ("pretrained.patch_embed.proj.weight", (384, 3, 14, 14)),
        ("pretrained.pos_embed", (1, 1370, 384)), ("pretrained.mask_token", (1, 384)),
        ("pretrained.blocks.11.attn.qkv.weight", (1152, 384)),
        ("pretrained.blocks.0.ls1.gamma", (384,)), ("pretrained.blocks.5.mlp.fc1.weight",
                                                    (1536, 384)),
        ("depth_head.projects.3.weight", (384, 384, 1, 1)),
        ("depth_head.resize_layers.0.weight", (48, 48, 4, 4)),
        ("depth_head.resize_layers.3.weight", (384, 384, 3, 3)),
        ("depth_head.scratch.layer1_rn.weight", (64, 48, 3, 3)),
        ("depth_head.scratch.refinenet4.resConfUnit1.conv1.weight", (64, 64, 3, 3)),
        ("depth_head.scratch.refinenet1.out_conv.weight", (64, 64, 1, 1)),
        ("depth_head.scratch.output_conv1.weight", (32, 64, 3, 3)),
        ("depth_head.scratch.output_conv2.2.weight", (1, 32, 1, 1)),
    ]:
        assert da.PARAM_SHAPES[key] == shape, key
    assert "depth_head.scratch.layer1_rn.bias" not in da.PARAM_SHAPES
    path = str(tmp_path / "da2.npz")
    weights.save_depth_anything_npz(path, m)
    back = weights.load_depth_anything(path, device="cpu", input_size=SIZE).state_dict()
    read = ref.load_checkpoint(path, "cpu")
    for key, v in sd.items():
        want = v.to(torch.bfloat16).float()
        assert torch.equal(back[key], want) and torch.equal(read[key], want), key
    torch.save(sd, tmp_path / "published.pth")
    from_pth = weights.load_depth_anything(str(tmp_path / "published.pth"), device="cpu")
    assert all(torch.equal(from_pth.state_dict()[k], v) for k, v in sd.items())
    with pytest.raises(FileNotFoundError):
        weights.load_depth_anything(str(tmp_path / "missing.npz"), device="cpu")


def test_depthnet_keypoint_depth_is_bit_equal_to_the_direct_calls():
    dn = depthnet.DepthNet(device="cpu")
    dn.load_state_dict(depthnet.init_params(seed=3))
    dn.eval()
    g = torch.Generator().manual_seed(4)
    gray = torch.randint(0, 256, (2, 120, 160), dtype=torch.uint8, generator=g)
    xy = torch.rand(2, 32, 2, generator=g) * torch.tensor([159.0, 119.0])
    want = depthnet.sample_log_depth_at_keypoints(depthnet.predict_log_depth(dn, gray), xy)
    assert torch.equal(frontend.predicted_keypoint_depth(dn, gray, xy), want)
    assert torch.equal(dn.keypoint_depth(gray, xy), want)


def test_the_depth_span_counts_tokens_and_reads_nothing_back(params, frames):
    from torch.utils._python_dispatch import TorchDispatchMode

    reads = []

    class CountReads(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._overloadpacket.__name__ in ("_local_scalar_dense", "nonzero"):
                reads.append(func)
            return func(*args, **(kwargs or {}))

    m = _model(params, torch.bfloat16)
    xy = torch.full((2, 8, 2), 10.0)
    with profiling.recording() as records, CountReads():
        got = frontend.predicted_keypoint_depth(m, frames, xy)
    assert not reads
    (span,) = [r for r in records if r.name == "frontend.depth"]
    assert span.frames == 2 and span.counts == {"tokens": 2 * (3 * 4 + 1)}
    assert torch.equal(got, m.keypoint_depth(frames, xy))


def test_a_monocular_run_coupled_takes_the_network():
    cfg = tiny_test_config().replace(rgbd=False)
    c = cfg.camera
    d = synthetic.make_image_sequence(4, width=c.width, height=c.height, fx=c.fx, fy=c.fy,
                                      cx=c.cx, cy=c.cy, seed=0, num_landmarks=500, radius=2.0)
    m = da.DepthAnythingV2(device="cpu", input_size=SIZE)
    m.load_state_dict(da.init_params(seed=2))
    m.eval()
    gray = torch.from_numpy(d["gray"]).reshape(1, 4, c.height, c.width)
    zeros = torch.zeros((1, 4, c.height, c.width), dtype=torch.int32)
    captured = []
    orig = frontend.frontend_features

    def capture(*args, **kwargs):
        out = orig(*args, **kwargs)
        captured.append(out)
        return out

    frontend.frontend_features = capture
    try:
        from vslam_tpu_torch.models import weights as w

        coupled.run_coupled(
            w.load_superpoint(device="cpu"), init_state(cfg, device="cpu"),
            gridhash.init_dense_map(cfg.dense.hash_capacity, cfg.dense.cloud_capacity,
                                    device="cpu"),
            gray, zeros, None, torch.from_numpy(d["timestamps"].astype(np.float32))[None],
            torch.arange(4, dtype=torch.int32)[None], torch.zeros((1, 4), dtype=torch.bool), cfg,
            depth_params=m, device="cpu")
    finally:
        frontend.frontend_features = orig
    (feats,) = captured
    assert int(feats.valid.sum()) > 0
    want = m.keypoint_depth(gray[0], feats.xy)
    assert torch.equal(feats.depth, want) and bool((want > 0).all())


def test_the_committed_checkpoint_is_trained():
    """The committed bf16 weights at the published input size, on one
    held-out frame of DepthNet's evaluation (measured abs_rel 0.046;
    DepthNet's checkpoint reads 0.122 on 16 frames)."""
    m = weights.load_depth_anything(device="cpu")
    assert m.compute_dtype == torch.bfloat16 and m.input_size == 518
    ev = tda.evaluate(m, n_images=1)
    assert ev["abs_rel"] < 0.08 and ev["delta_1.25"] > 0.95, ev


def test_one_training_step_lowers_the_loss():
    init, step, _ = tda.make_trainer(lr=1e-3, device="cpu", input_size=SIZE)
    state = init(seed=0)
    g = torch.Generator().manual_seed(5)
    gray = torch.randint(0, 256, (2, 42, 56), dtype=torch.uint8, generator=g)
    rows = torch.linspace(0.5, 2.0, 42)[None, :, None].expand(2, 42, 56)
    valid = torch.ones((2, 42, 56), dtype=torch.bool)
    key = prng.prng_key(1)
    state, first = step(state, gray, rows, valid, key)
    state, second = step(state, gray, rows, valid, key)
    assert state.step == 2 and torch.isfinite(first) and float(second) < float(first)
