"""Span around the frontend: SuperPoint (and DepthNet) over a chunk."""

MODULE, ATTR = "vslam_tpu_torch.core.frontend", "frontend_features"


def frames(a):
    return int(a["gray_u8"].shape[0])  # C, or C * B frames
