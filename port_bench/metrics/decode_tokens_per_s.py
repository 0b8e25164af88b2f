"""Tokens generated for the requests completed in the window, over all of
the window's time, prefills included."""


def read(run):
    return run.tokens / run.window_s if run.kind == "serve" else None
