from icl_torch.models.relation import RELATION_CLASSES, RelationModel
from icl_torch.models.rnn import LSTM, BiLSTM

__all__ = ["BiLSTM", "LSTM", "RELATION_CLASSES", "RelationModel"]
