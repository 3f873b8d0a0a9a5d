"""The entry's own time per frame of the window: each `entry` span less its
`frontend`, `track` and `fuse` children (`entry.copy`, the outputs' concatenation)."""

from slam_bench import program

# The spans it reads: the program's own, and the harness's frontend spans,
# which place the program's calls in the window.
SPANS = ("program", "frontend")


def read(run):
    return program.entry_ms_per_frame(run)
