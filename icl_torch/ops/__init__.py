"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Counterpart of ``icl/ops``.  A wrapper (``grid_head.grid_head``,
``lstm_recurrence.lstm_recurrence``) runs its kernel for CUDA tensors and
its plain version for CPU tensors; it counts its kernel launches in a
``launches`` attribute.  The kernels' sources are ``icl_torch/csrc/*.cu``,
built by :mod:`icl_torch.ops._build`.
"""
