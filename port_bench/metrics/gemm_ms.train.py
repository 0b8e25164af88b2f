"""Device time a step of cuBLAS / cuBLASLt / CUTLASS matmul kernels."""
PATTERNS = ("gemm", "nvjet", "cutlass", "xmma", "cublas", "sm90_", "sm80_")


def match(name):
    low = name.lower()
    return any(p in low for p in PATTERNS)


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    steps = run.trace.count("step")
    busy = run.trace.busy_s(match)
    return 1e3 * busy / steps if steps and busy > 0 else None
