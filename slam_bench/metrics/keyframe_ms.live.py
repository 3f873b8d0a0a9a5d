"""Self time of the tracking step's `step.keyframe` spans (insert, periodic
PnP, re-pose, loop closure) per frame of the window, over all frames."""

from slam_bench import program

# The spans it reads: the program's own, and the harness's frontend spans,
# which place the program's calls in the window.
SPANS = ("program", "frontend")


def read(run):
    return program.self_ms_per_frame(run, "step.keyframe")
