"""Span around the batched radius match (one step, all members)."""

MODULE, ATTR = "vslam_tpu_torch.ops.matching", "radius_descriptor_match_fused_batched"
SYNC = False  # inside the tracking span: markers only, in the traced chunk


def frames(a):
    return len(a["desc_q"])


def keep(a):
    """What the match's work is counted from (`frozen.radius_work`); each
    argument a (B, ...) tensor or B per-member tensors."""
    return dict(uv_q=a["uv_q"], valid_q=a["valid_q"], uv_db=a["uv_db"], valid_db=a["valid_db"],
                D=int(a["desc_q"][0].shape[-1]), radius_px=float(a["radius_px"]))
