"""Seconds from the process's start to the window's start (loading, weights,
warm-up, the cell's own set-up), the check's bookkeeping left out."""


def read(run):
    return run.setup_s
