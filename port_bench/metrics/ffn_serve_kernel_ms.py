"""Device time a decode step of B1's serving form (the up and down kernels)."""
KERNELS = ("ffn_up_tc_kernel", "ffn_down_tc_kernel")


def match(name):
    return any(k in name for k in KERNELS)


def read(run):
    if run.kind != "serve" or run.trace is None or not run.decode_steps:
        return None
    busy = run.trace.busy_s(match)
    return 1e3 * busy / run.decode_steps if busy > 0 else None
