"""Tokens trained in the window over the window's wall time; every step ends
in the host read of its loss."""


def read(run):
    return run.tokens / run.window_s if run.kind == "train" else None
