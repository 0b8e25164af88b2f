"""Device time a step covered by the masked-FFN training kernels (B1's
training form, B2, B3 and the f-block reduce): the union of their intervals,
since the reduce is a programmatic dependent that starts early."""
KERNELS = ("train_fwd_kernel", "train_dx_kernel", "train_dw_core_kernel",
           "train_dw_kernel", "train_fd_reduce_kernel")


def match(name):
    return any(k in name for k in KERNELS)


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    steps = run.trace.count("step")
    busy = run.trace.busy_s(match)
    return 1e3 * busy / steps if steps and busy > 0 else None
