"""Batched states for multi-sequence tracking.

Port of `replicate_state` (`vslam_tpu/parallel/mesh.py:34-37`) alone. The
rest of that module, the multi-device layout, waits for `ROADMAP.md`
Queue A 15.
"""

from __future__ import annotations

from vslam_tpu_torch.config import SlamConfig
from vslam_tpu_torch.core.state import TrackState, init_state, stack_trees


def replicate_state(config: SlamConfig, batch: int, device="cuda") -> TrackState:
    """`batch` independent initial tracking states, leaves (batch, ...).

    Every member owns its storage. The JAX package broadcasts one state,
    which is safe only because JAX never writes an array in place; the
    port writes the keyframe ring in place (`core.tracking`), so views of
    one state would share a ring."""
    return stack_trees([init_state(config, device=device)] * batch)
