"""Branch predicates the program read back from the device (`reads`, summed
over all its spans) per frame of the window (member-frame at B 4)."""

from slam_bench import program

# The spans it reads: the program's own, and the harness's frontend spans,
# which place the program's calls in the window.
SPANS = ("program", "frontend")


def read(run):
    return program.reads_per_frame(run)
