"""Kernel launches an affinity train step: every CUDA kernel in the
profiler's trace of the window (cuBLAS and PyTorch's own included) over the
steps taken, read as ``launches_per_step.relation_train`` reads it."""

from portbench.lib import cell


def read(run: dict):
    return cell.metric_reader("launches_per_step.relation_train").read(run)
