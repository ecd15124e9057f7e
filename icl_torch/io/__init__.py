"""File formats of the port (copy of ``icl/io``)."""
from icl_torch.io.feats import FeatsExample, read_feats, write_feats, parse_sparse_line
from icl_torch.io.captions import Caption, Mention, read_captions, read_mentions
from icl_torch.io.boxes import read_box_feats, write_box_feats
from icl_torch.io.scores import read_scores, write_scores

__all__ = [
    "FeatsExample", "read_feats", "write_feats", "parse_sparse_line",
    "Caption", "Mention", "read_captions", "read_mentions",
    "read_box_feats", "write_box_feats",
    "read_scores", "write_scores",
]
