"""The ``fused_gks`` entry's faults, planted in
``solvers.fused.fused_gks``."""
from ._common import solver_faults


def faults():
    from trips_tpu_torch.solvers import fused

    return solver_faults(fused, "fused_gks")
