"""Set-up seconds: from the process's start to the window's first call
(rendering, loading, the warm-up chunk; the first run in a checkout also
builds the kernels)."""


def read(run):
    return run.setup_s
