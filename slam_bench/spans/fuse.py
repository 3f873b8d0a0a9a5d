"""Span around dense fusion of one chunk of one stream."""

MODULE, ATTR = "vslam_tpu_torch.core.coupled", "fuse_chunk"


def frames(a):
    return int(a["depth_u16"].shape[0])
