"""Span around the frontend's depth network over a chunk (inside the
frontend span); in the traced chunk its records lie between marker
kernels of its own."""

MODULE, ATTR = "vslam_tpu_torch.core.frontend", "predicted_keypoint_depth"


def frames(a):
    return int(a["gray_u8"].shape[0])


def keep(a):
    """What the network's work is counted from (`da2_flops`): the frames,
    their size and the network's input size."""
    C, H, W = a["gray_u8"].shape
    return dict(frames=int(C), height=int(H), width=int(W),
                input_size=int(getattr(a["depth_model"], "input_size", 518)))
