"""Kernel launches a train step: every CUDA kernel in the profiler's trace
of the window (cuBLAS and PyTorch's own included) over the steps taken."""


def read(run: dict):
    t = run.get("trace")
    if t is None or not run["stats"].get("steps"):
        return None
    n = len(t.kernels())
    return n / run["stats"]["steps"] if n else None
