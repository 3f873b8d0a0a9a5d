"""Span around the local map's radius match (one frame)."""

MODULE, ATTR = "vslam_tpu_torch.ops.matching", "radius_descriptor_match_fused"
SYNC = False  # inside the tracking span: markers only, in the traced chunk


def frames(a):
    return 1


def keep(a):
    """What the match's work is counted from (`frozen.radius_work`)."""
    return dict(uv_q=a["uv_q"], valid_q=a["valid_q"], uv_db=a["uv_db"], valid_db=a["valid_db"],
                D=int(a["desc_q"].shape[-1]), radius_px=float(a["radius_px"]))
