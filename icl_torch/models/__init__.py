from icl_torch.models.affinity import (AFFINITY_CLASSES, AffinityModel,
                                      rank_boxes)
from icl_torch.models.relation import RELATION_CLASSES, RelationModel
from icl_torch.models.rnn import LSTM, BiLSTM

__all__ = ["AFFINITY_CLASSES", "AffinityModel", "BiLSTM", "LSTM",
           "RELATION_CLASSES", "RelationModel", "rank_boxes"]
