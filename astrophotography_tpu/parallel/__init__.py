"""Multi-chip scale-out: meshes, shardings, halo exchange, batch pipelines.

The reference is single-process Python with no parallelism of any kind
(SURVEY.md §2.6); this package supplies the device scaling axes:

* frame/data parallelism — stacks sharded over a 'frame' mesh axis;
* spatial parallelism — H x W sharded over a 'space' axis with halo
  exchange for stencil ops (the image-domain analogue of
  sequence/context parallelism);
* collectives ride jax/XLA (psum, all_gather, ppermute), which hands
  them to the device interconnect.
"""

from .mesh import (
    frame_space_mesh,
    shard_frames,
    shard_spatial,
    replicate,
)
from .halo import halo_exchange_rows, sharded_map_overlap
from .pipeline import AsyncWriter, PrefetchLoader, stream_stacks

__all__ = [
    "frame_space_mesh",
    "shard_frames",
    "shard_spatial",
    "replicate",
    "halo_exchange_rows",
    "sharded_map_overlap",
    "AsyncWriter",
    "PrefetchLoader",
    "stream_stacks",
]
