"""Multi-device runs of the port: device meshes, sharded inference and
the column-sharded CMF (:mod:`.mesh`). Data-parallel training is in
:mod:`srcfinder_torch.train.ddp`."""

from .mesh import (as_mesh, batch_ranges, column_ranges, gather, make_mesh,
                   replicate, run_shards, shard_columns_mf, shard_fcn_shifts)

__all__ = ["make_mesh", "as_mesh", "column_ranges", "batch_ranges", "replicate",
           "run_shards", "gather", "shard_columns_mf", "shard_fcn_shifts"]
