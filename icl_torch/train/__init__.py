from icl_torch.train.state import TrainState, create_train_state
from icl_torch.train.steps import (make_relation_train_step, relation_loss,
                                   relation_predict)

__all__ = ["TrainState", "create_train_state", "make_relation_train_step",
           "relation_loss", "relation_predict"]
