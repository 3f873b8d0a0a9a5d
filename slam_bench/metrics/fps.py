"""Frames per second: every frame of every stream in the window's whole
sequences, over the time from the first call's start to the last call's
end."""


def read(run):
    return run.fps()
