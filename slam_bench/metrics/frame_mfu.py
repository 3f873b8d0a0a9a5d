"""Model FLOPs of the traced frames (frozen flops: SuperPoint, DepthNet
where configured, the tracking matmuls) over the traced seconds and 989
TFLOP/s (%)."""

from slam_bench.readers import frame_mfu

# The spans it reads; the frontend and tracking spans frame the trace.
SPANS = ("frontend", "track", "track_batched")


def read(run):
    return frame_mfu(run)
