"""Span around one stream's tracking of a chunk."""

MODULE, ATTR = "vslam_tpu_torch.core.pipeline", "track_chunk"


def frames(a):
    return len(a["frame_ids"])
