"""Tracking span per frame (per member-frame in the batched step)."""

from slam_bench.readers import span_ms_per_frame

SPANS = ("track", "track_batched")  # the spans it reads


def read(run):
    return span_ms_per_frame(run, "track", "track_batched")
