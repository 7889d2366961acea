"""Device-mesh sharding: spatial scan parallelism + client data
parallelism, driven from one process (counterpart of
``foveax/parallel``)."""

from foveax_torch.parallel.mesh import make_mesh
from foveax_torch.parallel.sharded import (
    frame_parallel_roundtrip,
    multi_client_step,
    sharded_build_sat,
    sharded_sample_batch_fused,
)

__all__ = [
    "make_mesh",
    "sharded_build_sat",
    "multi_client_step",
    "frame_parallel_roundtrip",
    "sharded_sample_batch_fused",
]
