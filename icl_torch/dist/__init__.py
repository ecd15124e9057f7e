"""Data parallelism over ``torch.distributed`` (counterpart of ``icl/dist``):
the process mesh, row sharding of batches, the flat gradient all-reduce and
the part-file merge of sharded outputs.  See :mod:`icl_torch.dist.mesh`."""

from icl_torch.dist.mesh import (Mesh, all_reduce_sum, build_mesh,
                                 data_axis_size, gather_parts,
                                 is_main_process, local_data_rows,
                                 predict_mesh, predict_partition, replicate,
                                 shard_batch, shard_batch_local,
                                 sweep_data_axis_size, sync_processes)

__all__ = ["Mesh", "all_reduce_sum", "build_mesh", "data_axis_size",
           "gather_parts", "is_main_process", "local_data_rows",
           "predict_mesh", "predict_partition", "replicate", "shard_batch",
           "shard_batch_local", "sweep_data_axis_size", "sync_processes"]
