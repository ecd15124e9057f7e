from icl_torch.train.steps import relation_predict

__all__ = ["relation_predict"]
