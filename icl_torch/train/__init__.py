from icl_torch.train.state import TrainState, create_train_state
from icl_torch.train.steps import (affinity_loss, affinity_predict,
                                   make_affinity_train_step,
                                   make_mention_train_step,
                                   make_relation_train_step, mention_loss,
                                   mention_predict, relation_loss,
                                   relation_predict)

__all__ = ["TrainState", "affinity_loss", "affinity_predict",
           "create_train_state", "make_affinity_train_step",
           "make_mention_train_step", "make_relation_train_step",
           "mention_loss", "mention_predict", "relation_loss",
           "relation_predict"]
