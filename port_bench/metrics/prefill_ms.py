"""ServeEngine.stats over the window: prefill_s / prefills."""


def read(run):
    if run.kind != "serve" or run.trace is None or not run.stats["prefills"]:
        return None
    return 1e3 * run.stats["prefill_s"] / run.stats["prefills"]
