"""Dense fusion span per frame (per member-frame with several streams)."""

from slam_bench.readers import span_ms_per_frame

SPANS = ("fuse",)  # the spans it reads


def read(run):
    return span_ms_per_frame(run, "fuse")
