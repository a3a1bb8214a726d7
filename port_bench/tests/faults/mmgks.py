"""The ``mmgks`` entry's faults, planted in ``solvers.MMGKS``."""
from ._common import solver_faults


def faults():
    from trips_tpu_torch import solvers

    return solver_faults(solvers, "MMGKS")
