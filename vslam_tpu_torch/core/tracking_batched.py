"""Multi-sequence tracking: B independent sequences, one frame each per step.

Port of `vslam_tpu/core/tracking_batched.py`. States are a `TrackState`
whose leaves carry a leading B dimension, frames a `FrameFeatures` with
(B, ...) leaves, as in the JAX package. Member b computes what
`tracking.tracking_step` computes for it alone, bit for bit.

How the JAX step's blocks map here:

  * Hoisted blocks (JAX: `lax.cond(jnp.any(mask))` around a vmap, then a
    per-member `_select`): bootstrap, the track body itself, bridge,
    essential fallback, recovery, keyframe creation + cull, periodic PnP
    and loop closure. The port reads the whole (B,) mask back once per
    block (one host sync, counted in `tracking.STATS["branch_reads"]`)
    and runs the block only for the members whose mask is set (`_read`
    also charges the read to the innermost open span of
    `utils.profiling`, while its recorder is on). Bootstrap,
    bridge and keyframe creation write the keyframe ring in place, so
    computing them for an unmasked member and selecting afterwards would
    corrupt that member's ring; and the members a block skips keep what
    they had, so neither `_select` nor `_zero_outputs` has a counterpart.
  * Always-on blocks (JAX: vmap): keyframe match, F-gate, 3D-3D RANSAC,
    motion composition, EKF fusion, PnP refinement, keyframe policy and
    the final state: member by member, through the single-sequence
    helpers of `core.tracking`, on member views of the batched storage
    (`state.member`), so that in-place writes land in it. Vectorising
    them is later work. On the card the members' calls of a graphed
    function (`ops.graphs`: the epipolar RANSACs, both halves of
    `step.pose`) replay one graph, one member after another.
  * Local-map tracking (step 7, `_track_local_map_batched`): each
    member's map is projected, then ONE batched radius match runs for all
    members (`ops.matching.radius_descriptor_match_fused_batched`, one
    kernel launch per frame on the card, handed each member's own tensors
    rather than stacked copies), then the visible/found counters.

The step returns a new batched state whose keyframe ring is the one it
was given, updated in place; every other leaf is new.

Spans (`utils.profiling.span`): the single-sequence step's, each block
covering every member it runs for (`frames`: member-frames): `step`
around each `tracking_step_batched`; `step.bootstrap`; `step.match`
(match, bridge, F-gate); `step.motion` (3D-3D, essential fallback,
composition, recovery); `step.pose` (EKF fusion; later PnP refinement,
the keyframe policy and the read of its mask); `step.map` (the batched
local map); `step.keyframe` (steps in which some member keyframes);
`step.finish` (`_finish` per member in the track body, and
`stack_trees` in every step).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import List, Tuple

import torch

from vslam_tpu_torch.config import SlamConfig
from vslam_tpu_torch.core import tracking as T
from vslam_tpu_torch.core.state import (
    FrameFeatures,
    StepOutputs,
    TrackState,
    member,
    stack_trees,
)
from vslam_tpu_torch.ops import matching, prng
from vslam_tpu_torch.ops.linalg import f32_matmuls
from vslam_tpu_torch.utils import profiling

# Counters a caller can read after a run: steps in which any member
# tracked, and for each hoisted block the member-frames it ran for.
STATS = {"track_steps": 0, "bootstrap": 0, "bridge": 0, "essential": 0, "recover": 0,
         "keyframe": 0, "periodic_pnp": 0, "loop": 0}


def reset_stats():
    for k in STATS:
        STATS[k] = 0


def _read(mask: torch.Tensor) -> List[bool]:
    """Read a (B,) predicate back from the device (one host sync),
    counted in `tracking.STATS` and charged to the innermost open span."""
    T.STATS["branch_reads"] += 1
    profiling.count_read()
    return mask.tolist()


def _hoisted(block: str, records, attr: str):
    """The records whose predicate `attr` is set, read back at once: the
    members a hoisted block runs for. Reads nothing when no record is
    left."""
    if not records:
        return []
    mask = _read(torch.stack([getattr(x, attr) for x in records]))
    STATS[block] += sum(mask)
    return [x for x, on in zip(records, mask) if on]


def _track_local_map_batched(sts, frs, config: SlamConfig, R_new, t_new):
    """Step 7 for member lists: project each member's map at its pose,
    radius-match all members in one call, update the counters.
    Returns (mp_idx, kp_ok, maps), one entry per member."""
    proj = [T._project_map(s.map, config, R, t) for s, R, t in zip(sts, R_new, t_new)]
    mp_idx, kp_ok, _, min_pix_d2 = matching.radius_descriptor_match_fused_batched(
        [f.desc for f in frs], [f.xy for f in frs], [f.valid for f in frs],
        [s.map.desc for s in sts], [p[0] for p in proj], [p[1] for p in proj],
        radius_px=config.map.track_search_radius_px,
        desc_thresh=config.map.track_desc_threshold,
    )
    maps = [T._count_found(s.map, config, p[1], min_pix_d2[b])
            for b, (s, p) in enumerate(zip(sts, proj))]
    return list(mp_idx), list(kp_ok), maps


def _track_batched(sts, frs, config: SlamConfig, keys):
    """`tracking._track` for member lists (every member past bootstrap):
    the always-on blocks member by member, each hoisted block for its
    members only, step 7 batched. Returns [(state, outputs)] per member."""
    # k: match, motion, pnp, recover, loop, periodic, fgate
    r = [SimpleNamespace(st0=s, st=s, f=f, k=prng.split(k, 7)) for s, f, k in zip(sts, frs, keys)]
    n = len(r)

    with profiling.span("step.match", frames=n):
        for x in r:  # 1. keyframe match
            x.m, x.uv_kf, x.uv_cur, x.gated, x.n_raw = T._match_to_keyframe(x.st, x.f, config,
                                                                            x.k[0])
            x.can_bridge = T._bridge_due(x.st, x.n_raw, config)
        for x in _hoisted("bridge", r, "can_bridge"):  # 2. bridge keyframe
            x.st, x.m, x.uv_kf, x.uv_cur, x.gated, x.n_raw = T._bridge(x.st, x.f, config, x.k[0])
        for x in r:  # 2b. F-gate
            x.gated, x.epi_before, x.epi_after = T._gate(x.uv_kf, x.uv_cur, x.gated, config,
                                                         x.k[6])
            x.n_matches = torch.sum(x.gated)

    with profiling.span("step.motion", frames=n):
        for x in r:  # 3. 3D-3D motion
            x.k_3d3d, x.k_ess = prng.split(x.k[1], 2)
            (x.R3, x.t3, x.res3, x.p_kf, x.p_cur, x.d_ok) = T._motion_3d3d(
                x.st, x.f, config, x.m, x.uv_kf, x.uv_cur, x.gated, x.k_3d3d)
            x.use_3d3d = x.res3.ok & bool(config.rgbd)
            x.need_e = ~x.use_3d3d
            x.ess = T._essential_skipped(x.st, x.R3, x.t3, x.res3)
        for x in _hoisted("essential", r, "need_e"):  # 4. essential fallback
            x.ess = T._motion_essential(x.st, x.f, config, x.uv_kf, x.uv_cur, x.gated, x.p_kf,
                                        x.p_cur, x.d_ok, x.k_ess)
        for x in r:
            (x.R_mot, x.t_mot, x.motion_ok, x.n_inl, x.new_scale,
             x.n_depth_ok) = T._compose_motion(x.st, x.use_3d3d, x.R3, x.t3, x.res3, x.ess,
                                               x.gated, x.d_ok)
            enough = x.n_matches >= config.frontend.min_matches
            x.motion_ok = x.motion_ok & enough
            x.can_recover = T._recover_due(x.st, enough, config)
            x.R_rec, x.t_rec, x.rec_ok = T._no_recovery(x.st)
        for x in _hoisted("recover", r, "can_recover"):  # 5. PnP recovery
            x.R_rec, x.t_rec, x.rec_ok = T._try_pnp_recovery(x.st, x.f, config, x.k[3])

    with profiling.span("step.pose", frames=n):
        for x in r:  # 6. EKF fusion
            x.recovered = x.can_recover & x.rec_ok
            x.R_new, x.t_new, x.ekf, x.snap = T._fuse_pose(
                x.st, x.f, config, x.R_mot, x.t_mot, x.use_3d3d, x.motion_ok, x.recovered,
                x.R_rec, x.t_rec)

    with profiling.span("step.map", frames=n):  # 7. local map: one batched radius match
        mp_idx, kp_ok, maps = _track_local_map_batched(
            [x.st for x in r], [x.f for x in r], config, [x.R_new for x in r],
            [x.t_new for x in r])
        for x, mi, ko, mp in zip(r, mp_idx, kp_ok, maps):
            x.mp_idx, x.kp_ok = mi, ko
            x.st = x.st._replace(map=mp)
            x.n_tracked = torch.sum(ko)

    with profiling.span("step.pose", frames=n):  # 8. PnP refine; keyframe policy
        for x in r:
            x.R_fin, x.t_fin, x.R_kfp, x.t_kfp, x.is_kf = T._refine_and_decide(
                x.st, x.f, config, x.R_new, x.t_new, x.mp_idx, x.kp_ok, x.n_matches,
                x.motion_ok, x.recovered)
            x.st_kf = x.st
        kfs = _hoisted("keyframe", r, "is_kf")

    if kfs:
        with profiling.span("step.keyframe", frames=len(kfs)):
            for x in kfs:  # 9. keyframe creation + cull
                x.st_kf = T._insert_keyframe(x.st, x.f, config, x.R_kfp, x.t_kfp, x.m, x.gated,
                                             x.mp_idx, x.kp_ok)
                x.periodic = T._periodic_due(x.st_kf, config)
                x.R_kf, x.t_kf = x.R_kfp, x.t_kfp
            for x in _hoisted("periodic_pnp", kfs, "periodic"):  # 10. periodic PnP
                x.R_kf, x.t_kf = T._periodic_pnp(x.st_kf, x.f, config, x.R_kfp, x.t_kfp,
                                                 x.mp_idx, x.kp_ok, x.k[5])
            for x in kfs:
                x.st_kf = T._repose_keyframe(x.st_kf, x.R_kf, x.t_kf)
                x.R_fin, x.t_fin = x.R_kf, x.t_kf
                x.loop = T._loop_due(x.st_kf, config)
            for x in _hoisted("loop", kfs, "loop"):  # 11. loop closure
                x.st_kf = T._handle_loop_closure(x.st_kf, x.f, config, x.R_kf, x.t_kf, x.k[4])

    with profiling.span("step.finish", frames=n):
        return [  # 12. finalize
            T._finish(x.st0, x.st_kf, x.f, config, x.R_fin, x.t_fin, x.ekf, x.snap, x.new_scale,
                      x.motion_ok, x.recovered, n_matches=x.n_matches, n_inl=x.n_inl,
                      n_tracked=x.n_tracked, is_kf=x.is_kf, used_3d3d=x.use_3d3d,
                      epi_before=x.epi_before, epi_after=x.epi_after, bridged=x.can_bridge,
                      n_depth_ok=x.n_depth_ok)
            for x in r
        ]


def tracking_step_batched(states: TrackState, frames: FrameFeatures, config: SlamConfig,
                          keys) -> Tuple[TrackState, StepOutputs]:
    """One frame for each of B sequences, in full f32. `keys` holds one
    host threefry key per member. Updates the keyframe rings of `states`
    in place (see the module docstring). Returns (states', outputs with
    (B, ...) leaves)."""
    B = frames.timestamp.shape[0]
    with profiling.span("step", frames=B), f32_matmuls():
        frames = frames._replace(desc=frames.desc.to(states.kf_desc.dtype))
        r = [SimpleNamespace(view=member(states, b), f=member(frames, b), k=keys[b])
             for b in range(B)]
        for x in r:
            x.boot = x.view.kf_frame_id < 0
        booting = _hoisted("bootstrap", r, "boot")
        if booting:
            with profiling.span("step.bootstrap", frames=len(booting)):
                for x in booting:
                    x.st, x.out = T._bootstrap(x.view, x.f, config)
        track = [x for x in r if all(x is not y for y in booting)]
        if track:  # the track body runs for the members past bootstrap only
            STATS["track_steps"] += 1
            T.STATS["track_frames"] += len(track)
            res = _track_batched([x.view for x in track], [x.f for x in track], config,
                                 [x.k for x in track])
            for x, (st, out) in zip(track, res):
                x.st, x.out = st, out
        with profiling.span("step.finish", frames=B):
            if any(x.st.keyframes is not x.view.keyframes for x in r):
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
