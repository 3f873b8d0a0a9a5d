"""The program's host syncs (CUDA sync debug mode, the harness's own left
out) per frame of the traced window."""


def read(run):
    return run.host_syncs / run.frames if run.host_syncs is not None and run.frames else None
