"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Counterpart of ``icl/ops``.  A kernel wrapper (``grid_head.grid_head``,
``lstm_recurrence.lstm_recurrence``, the four ``grid_head_train.*_fwd`` /
``*_bwd``, ``affinity_rank.affinity_rank``) runs its kernel for CUDA
tensors and its plain version for CPU tensors; it counts its kernel
launches in a ``launches`` attribute, and those of its bf16 mode apart
(``grid_head.bf16dot``, ``affinity_rank.bf16dot``,
``lstm_recurrence.bf16``, each with its own ``launches``).  The training heads and the
recurrence are ``torch.autograd.Function``s over those wrappers; the
recurrence's backward kernel counts in ``lstm_recurrence.bwd.launches``.  The
kernels' sources are ``icl_torch/csrc/*.cu``, built by
:mod:`icl_torch.ops._build`; ``ce`` holds the shared cross-entropy.
"""
