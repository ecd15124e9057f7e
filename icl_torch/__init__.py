"""icl_torch — the PyTorch and CUDA port of ``icl`` for NVIDIA Hopper (H100).

Module names mirror ``icl/``.  The port imports ``torch`` and never JAX,
and nothing of ``icl``: it keeps its own copies of the numpy data layer
(``data``, ``io``, ``eval``, ``testing``, ``util``), held to the originals by
the tests, so file formats and batch layouts are the same.  Weights cross
from the JAX package through the ``icl-export`` flat ``.npz`` + manifest
(:mod:`icl_torch.params`).

Layers:
  icl_torch.ops     hand-written CUDA kernels (csrc/*.cu) + plain versions
  icl_torch.models  nn.Modules: masked LSTM/BiLSTM, the relation and
                    affinity models, the two mention FFNNs (nonvisual,
                    cardinality)
  icl_torch.train   train state (Adam, dropout seeds), train and predict
                    steps, the train loop, checkpoints, the dev eval hooks
  icl_torch.cli     icl-torch-relation, -affinity, -nonvisual, -cardinality,
                    -joint, -export, -import, -eval, -check, -baseline
  icl_torch.serve   HTTP scoring service (the four tasks)
"""

__version__ = "0.1.0"
