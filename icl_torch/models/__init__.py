from icl_torch.models.affinity import (AFFINITY_CLASSES, AffinityModel,
                                      rank_boxes)
from icl_torch.models.cardinality import CARDINALITY_CLASSES, CardinalityModel
from icl_torch.models.nonvisual import (NONVIS_CLASSES, NonvisualModel,
                                       mean_pool_tokens)
from icl_torch.models.relation import RELATION_CLASSES, RelationModel
from icl_torch.models.rnn import LSTM, BiLSTM

__all__ = ["AFFINITY_CLASSES", "AffinityModel", "BiLSTM",
           "CARDINALITY_CLASSES", "CardinalityModel", "LSTM",
           "NONVIS_CLASSES", "NonvisualModel", "RELATION_CLASSES",
           "RelationModel", "mean_pool_tokens", "rank_boxes"]
