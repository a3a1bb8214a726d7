"""Dynamic CT beyond one resident operator, and operators split over ranks
(counterpart of ``trips_tpu/parallel``): the sharded ELL, BSR-as-CSR and
banded operators on ``torch.distributed`` (whole vectors on every rank,
one all_reduce per apply), the process-group start-up and meshes, the
streamed out-of-core operator and the per-frame batched solve."""
from .batched import batched_frame_solve, stack_ell_tables
from .multihost import init_multihost, pod_mesh
from .sharded_banded import (ShardedBandedProjector,
                             ShardedBucketedBandedProjector)
from .sharded_bsr import ShardedBsrOperator, ShardedDynamicBsrOperator
from .sharded_dynamic_banded import (ShardedBucketedDynamicBandedOperator,
                                     ShardedDynamicBandedOperator)
from .sharding import (Mesh, ShardedDynamicOperator, ShardedEllOperator,
                       collective_counts, make_mesh, reset_collective_counts)
from .streamed import StreamedDynamicBandedOperator, cgls_normal_streamed

__all__ = ["Mesh", "ShardedBandedProjector", "ShardedBsrOperator",
           "ShardedBucketedBandedProjector",
           "ShardedBucketedDynamicBandedOperator",
           "ShardedDynamicBandedOperator", "ShardedDynamicBsrOperator",
           "ShardedDynamicOperator", "ShardedEllOperator",
           "StreamedDynamicBandedOperator", "batched_frame_solve",
           "cgls_normal_streamed", "collective_counts", "init_multihost",
           "make_mesh", "pod_mesh", "reset_collective_counts",
           "stack_ell_tables"]
