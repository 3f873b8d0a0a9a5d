"""Self time of the tracking step's `step.pose` spans (EKF fusion, PnP
refinement, the keyframe decision) per frame of the window (member-frame at B 4)."""

from slam_bench import program

# The spans it reads: the program's own, and the harness's frontend spans,
# which place the program's calls in the window.
SPANS = ("program", "frontend")


def read(run):
    return program.self_ms_per_frame(run, "step.pose")
