"""The viewer helpers the web viewer needs: per-frame HUD text and the
loop-closure edges.

Port of `hud_text` and `loop_edges_from_state` from
`vslam_tpu/viz/viewer.py`. That module also renders PNG frames with
matplotlib (`render_run`, the app's `--render`); the port does not carry
that renderer yet (`ROADMAP.md`), so this module imports no matplotlib.
"""

from __future__ import annotations

import numpy as np

# The StepOutputs fields `hud_text` reads.
HUD_FIELDS = ("num_matches", "num_inliers", "num_tracked", "epi_before", "epi_after",
              "used_3d3d", "is_keyframe", "tracking_ok", "bridged", "recovered")


def hud_text(outputs, i):
    """Per-frame HUD lines from StepOutputs diagnostics (host numpy
    fields; `src/main.cpp:1220-1260`): counters, epipolar error
    before/after the fundamental gate, backend label, and event badges."""
    o = outputs
    lines = [
        f"frame {i}",
        f"matches  {int(np.asarray(o.num_matches)[i])}",
        f"inliers  {int(np.asarray(o.num_inliers)[i])}",
        f"tracked  {int(np.asarray(o.num_tracked)[i])}",
        f"epi err  {float(np.asarray(o.epi_before)[i]):.2f} -> "
        f"{float(np.asarray(o.epi_after)[i]):.2f} px",
        f"backend  {'3D-3D' if bool(np.asarray(o.used_3d3d)[i]) else 'E-matrix'}",
        f"keyframe {'YES' if bool(np.asarray(o.is_keyframe)[i]) else 'no'}",
        f"tracking {'OK' if bool(np.asarray(o.tracking_ok)[i]) else 'LOST'}",
    ]
    if bool(np.asarray(o.bridged)[i]):
        lines.append("BRIDGE KF")
    if bool(np.asarray(o.recovered)[i]):
        lines.append("PNP RECOVERY")
    return lines


def _host(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def loop_edges_from_state(st):
    """Loop-closure edge segments (world positions of the two keyframe
    endpoints) from the tracked state's constraint ring; the reference
    implements `draw_loop_edges` (`src/Viewer.cpp:76-130`) but never calls
    it; here the edges render whenever constraints exist."""
    kf_t = _host(st.keyframes.t)
    kf_valid = _host(st.keyframes.valid)
    edges = []
    for a, b, v in zip(_host(st.loops.kf_from), _host(st.loops.kf_to), _host(st.loops.valid)):
        if v and 0 <= a < len(kf_t) and 0 <= b < len(kf_t):
            if kf_valid[a] and kf_valid[b]:
                edges.append((kf_t[a], kf_t[b]))
    return edges
