"""Frontend span (SuperPoint, DepthNet where configured) per frame."""

from slam_bench.readers import span_ms_per_frame

SPANS = ("frontend",)  # the spans it reads


def read(run):
    return span_ms_per_frame(run, "frontend")
