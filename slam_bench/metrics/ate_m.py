"""RMSE of the aligned position errors of the window's first whole sequence
against the generator's ground truth (SE(3) with depth, sim(3) without;
pooled over streams)."""


def read(run):
    return run.ate_m
