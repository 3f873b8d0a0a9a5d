"""The 95th percentile of every frame's latency in the window, from the
hand-in to its pose on the host (ms)."""

from slam_bench.readers import p95


def read(run):
    return p95(run.latencies_ms())
