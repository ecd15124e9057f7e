"""The numpy data layer of the port (copy of ``icl/data``)."""
from icl_torch.data.embeddings import EmbeddingStore
from icl_torch.data.buckets import Bucketizer, BucketSpec

__all__ = ["EmbeddingStore", "Bucketizer", "BucketSpec"]
