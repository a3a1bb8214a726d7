"""Dynamic CT beyond one resident operator: the streamed out-of-core
operator and the per-frame batched solve (counterpart of
``trips_tpu/parallel``; its sharded operators are not ported yet)."""
from .batched import batched_frame_solve, stack_ell_tables
from .streamed import StreamedDynamicBandedOperator, cgls_normal_streamed

__all__ = ["StreamedDynamicBandedOperator", "batched_frame_solve",
           "cgls_normal_streamed", "stack_ell_tables"]
