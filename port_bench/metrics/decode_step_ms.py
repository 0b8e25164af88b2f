"""ServeEngine.stats over the window: decode_s / decode_steps, host-clocked
by the engine around chunks that end in a host copy."""


def read(run):
    if run.kind != "serve" or run.trace is None or not run.stats["decode_steps"]:
        return None
    return 1e3 * run.stats["decode_s"] / run.stats["decode_steps"]
