"""1 - (union of every device operation's interval) / (the traced window)."""


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
