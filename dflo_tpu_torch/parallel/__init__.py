"""Domain decomposition: the state as a grid of blocks over a device mesh."""

from dflo_tpu_torch.parallel.sharding import (DeviceMesh, compatible_shape,
                                              device_mesh, exchange_halos,
                                              gather_state, mesh_grid_shape,
                                              reduce_max, reduce_min,
                                              shard_state)

__all__ = ["DeviceMesh", "compatible_shape", "device_mesh", "exchange_halos",
           "gather_state", "mesh_grid_shape", "reduce_max", "reduce_min",
           "shard_state"]
