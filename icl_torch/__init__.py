"""icl_torch — the PyTorch and CUDA port of ``icl`` for NVIDIA Hopper (H100).

Module names mirror ``icl/``.  The port imports ``torch`` and never JAX; it
shares the numpy data layer (``icl.data``, ``icl.io``, ``icl.testing``,
``icl.util``) with the JAX package, so file formats and batch layouts are
the same.  Weights cross from the JAX package through the ``icl-export``
flat ``.npz`` + manifest (:mod:`icl_torch.params`).

Layers:
  icl_torch.ops     hand-written CUDA kernels (csrc/*.cu) + plain versions
  icl_torch.models  nn.Modules: masked LSTM/BiLSTM, the relation and
                    affinity models
  icl_torch.train   train state (Adam, dropout seeds), train and predict
                    steps
  icl_torch.serve   HTTP scoring service (relation, affinity)
"""

__version__ = "0.1.0"
