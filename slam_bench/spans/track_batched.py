"""Span around the batched tracking of a chunk (all members)."""

MODULE, ATTR = "vslam_tpu_torch.core.tracking_batched", "run_frames_batched"


def frames(a):
    ids = a["frame_ids"]  # (C, B) on the host
    return len(ids) * len(ids[0])
