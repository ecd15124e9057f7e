"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Counterpart of ``icl/ops``.  A kernel wrapper (``grid_head.grid_head``,
``lstm_recurrence.lstm_recurrence``, the four ``grid_head_train.*_fwd`` /
``*_bwd``, ``affinity_rank.affinity_rank``) runs its kernel for CUDA
tensors and its plain version for CPU tensors; it counts its kernel
launches (:func:`icl_torch.util.trace.launched`, which a CUDA graph's
replay makes again) in a ``launches`` attribute, and those of its bf16
mode apart
(``grid_head.bf16dot``, ``affinity_rank.bf16dot``,
``lstm_recurrence.bf16``, each with its own ``launches``).  The training heads and the
recurrence are ``torch.autograd.Function``s over those wrappers; the
recurrence's backward kernel counts in ``lstm_recurrence.bwd.launches``.  The
kernels' sources are ``icl_torch/csrc/*.cu``, built by
:mod:`icl_torch.ops._build`; ``ce`` holds the shared cross-entropy.
:func:`launch_counters` names every counter.
"""


def launch_counters() -> dict:
    """Every kernel's count of launches, by name: the objects whose
    ``launches`` (and the bf16 dot's ``mma_launches``) count them."""
    from icl_torch.ops import grid_head_train as ght
    from icl_torch.ops.affinity_rank import affinity_rank
    from icl_torch.ops.grid_head import grid_head
    from icl_torch.ops.lstm_recurrence import lstm_recurrence

    return {"grid_head": grid_head, "lstm_recurrence": lstm_recurrence,
            "lstm_recurrence_bwd": lstm_recurrence.bwd,
            "grid_head_train_fwd": ght.grid_head_train_fwd,
            "grid_head_train_bwd": ght.grid_head_train_bwd,
            "grid_head_train_loss_fwd": ght.grid_head_train_loss_fwd,
            "grid_head_train_loss_bwd": ght.grid_head_train_loss_bwd,
            "affinity_rank": affinity_rank,
            # the bf16 modes
            "grid_head_bf16dot": grid_head.bf16dot,
            "lstm_recurrence_bf16": lstm_recurrence.bf16,
            "lstm_recurrence_bwd_bf16": lstm_recurrence.bwd_bf16,
            "affinity_rank_bf16dot": affinity_rank.bf16dot,
            # the one-pass bf16 mode of the training kernels
            "grid_head_train_fwd_onepass": ght.grid_head_train_fwd.onepass,
            "grid_head_train_bwd_onepass": ght.grid_head_train_bwd.onepass,
            "grid_head_train_loss_fwd_onepass":
                ght.grid_head_train_loss_fwd.onepass,
            "grid_head_train_loss_bwd_onepass":
                ght.grid_head_train_loss_bwd.onepass}
