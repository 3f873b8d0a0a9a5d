"""Multi-sequence tracking: B independent sequences, one frame each per step.

Port of `vslam_tpu/core/tracking_batched.py`. States are a `TrackState`
whose leaves carry a leading B dimension, frames a `FrameFeatures` with
(B, ...) leaves, as in the JAX package. The step is the body of
`core.tracking` run over B members, the member views of the batched
storage (`state.member`), so that the keyframe ring's in-place writes
land in it; member b computes what `tracking.tracking_step` computes for
it alone, bit for bit. Each hoisted block reads the whole (B,) mask back
once and runs for the members whose mask is set, so neither the JAX
step's `_select` nor its `_zero_outputs` has a counterpart; the local map
radius-matches all members in one batched kernel launch.

The step returns a new batched state whose keyframe ring is the one it
was given, updated in place; every other leaf is new. Spans: the
single-sequence step's, each block covering every member it runs for
(`frames`: member-frames), and a second `step.finish` in every step
around `stack_trees`.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Tuple

from vslam_tpu_torch.config import SlamConfig
from vslam_tpu_torch.core import tracking as T
from vslam_tpu_torch.core.state import FrameFeatures, StepOutputs, TrackState, member, stack_trees
from vslam_tpu_torch.ops.linalg import f32_matmuls
from vslam_tpu_torch.utils import profiling

# Counters a caller can read after a run: steps in which any member
# tracked (the blocks' member-frames are in `tracking.STATS`).
STATS = {"track_steps": 0}


def reset_stats():
    for k in STATS:
        STATS[k] = 0


def tracking_step_batched(states: TrackState, frames: FrameFeatures, config: SlamConfig,
                          keys) -> Tuple[TrackState, StepOutputs]:
    """One frame for each of B sequences, in full f32. `keys` holds one
    host threefry key per member. Updates the keyframe rings of `states`
    in place (see the module docstring). Returns (states', outputs with
    (B, ...) leaves)."""
    B = frames.timestamp.shape[0]
    with profiling.span("step", frames=B), f32_matmuls():
        frames = frames._replace(desc=frames.desc.to(states.kf_desc.dtype))
        r = [SimpleNamespace(st=member(states, b), f=member(frames, b), k=keys[b])
             for b in range(B)]
        rings = [x.st.keyframes for x in r]
        if T._track(r, config, contiguous=False):
            STATS["track_steps"] += 1
        with profiling.span("step.finish", frames=B):
            if any(x.st.keyframes is not ring for x, ring in zip(r, rings)):
                raise RuntimeError("a member's keyframe ring was replaced rather than written "
                                   "in place: the batched ring would lose that write")
            st = TrackState(*(
                states.keyframes if name == "keyframes"
                else stack_trees([getattr(x.st, name) for x in r])
                for name in TrackState._fields
            ))
            return st, stack_trees([x.out for x in r])


def make_batched_scan_step(config: SlamConfig, seed: int = 42):
    """The step closure of the JAX package's `make_batched_scan_step`:
    `step(states, frames, frame_ids=None)` runs `tracking_step_batched`
    with member b's key `fold_in(PRNGKey(seed), frame_id[b])`. `frame_ids`
    are the (B,) ids on the host; without them the step reads
    `frames.frame_id` back from the device (one host sync)."""

    def scan_fn(states: TrackState, frames: FrameFeatures, frame_ids=None):
        fids = frames.frame_id.tolist() if frame_ids is None else frame_ids
        return tracking_step_batched(states, frames, config,
                                     [T.frame_key(seed, fid) for fid in fids])

    return scan_fn


def run_frames_batched(states: TrackState, frames: FrameFeatures, frame_ids, config: SlamConfig,
                       seed: int = 42):
    """The JAX package's `lax.scan(make_batched_scan_step(config, seed),
    states, frames)` as a Python loop: frames (N, B, ...), frame_ids the
    (N, B) frame ids on the host. Returns (states, outputs with
    (N, B, ...) leaves)."""
    step = make_batched_scan_step(config, seed)
    outs = []
    for i, fids in enumerate(frame_ids):
        states, out = step(states, T.frame_at(frames, i), fids)
        outs.append(out)
    return states, stack_trees(outs)


def batched_tracking_scan(states: TrackState, frames: FrameFeatures, config: SlamConfig,
                          seed: int = 42):
    """Run the batched step over (B, N, ...) frame stacks (the layout of
    the JAX package's `batched_tracking_scan`). Reads the frame ids back
    once. Returns (states, outputs with (B, N, ...) leaves)."""
    frames_t = FrameFeatures(*(x.transpose(0, 1) for x in frames))
    states, outs = run_frames_batched(states, frames_t, frames_t.frame_id.tolist(), config, seed)
    return states, StepOutputs(*(x.transpose(0, 1) for x in outs))
