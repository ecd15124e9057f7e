"""Kernel launches a batch: every CUDA kernel in the profiler's trace of
the window (cuBLAS and PyTorch's own included) over the batches the four
sweeps read back in it."""


def read(run: dict):
    t = run.get("trace")
    if t is None or not run["stats"].get("batches"):
        return None
    n = len(t.kernels())
    return n / run["stats"]["batches"] if n else None
