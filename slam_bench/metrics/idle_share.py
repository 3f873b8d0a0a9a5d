"""Share of the traced chunk in which no record ran on the device (%)."""

from slam_bench.readers import idle_share

# The spans it reads; the frontend and tracking spans frame the trace.
SPANS = ("frontend", "track", "track_batched")


def read(run):
    return idle_share(run)
