"""Leveled logging for the port (copy of ``icl/util``)."""
from icl_torch.util.log import LogUtil

__all__ = ["LogUtil"]
