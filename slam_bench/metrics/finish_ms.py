"""Self time of the tracking step's `step.finish` spans (the state carried on and
the outputs, made contiguous or stacked) per frame of the window (member-frame at B 4)."""

from slam_bench import program

# The spans it reads: the program's own, and the harness's frontend spans,
# which place the program's calls in the window.
SPANS = ("program", "frontend")


def read(run):
    return program.self_ms_per_frame(run, "step.finish")
