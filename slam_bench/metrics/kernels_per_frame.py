"""Device records (kernels, copies, fills) between the trace's markers per
frame (member-frame)."""

from slam_bench.readers import kernels_per_frame

# The spans it reads; the frontend and tracking spans frame the trace.
SPANS = ("frontend", "track", "track_batched")


def read(run):
    return kernels_per_frame(run)
