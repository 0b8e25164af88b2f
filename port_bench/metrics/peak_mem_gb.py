"""torch.cuda.max_memory_allocated() over the whole run up to the window's
end, set-up included, in GB (1e9 bytes)."""


def read(run):
    return run.peak_bytes / 1e9
