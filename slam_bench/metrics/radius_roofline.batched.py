"""The batched radius match's least time on its own inputs over its device
time, in the traced chunk (%)."""

from slam_bench.readers import radius_roofline

# The spans it reads; the frontend and tracking spans frame the trace.
SPANS = ("frontend", "track_batched", "radius_batched")


def read(run):
    return radius_roofline(run, "radius_batched")
