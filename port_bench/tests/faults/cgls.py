"""The ``cgls`` entry's faults, planted in ``krylov/cgls.py``."""
from ._common import krylov_faults


def faults():
    return krylov_faults("_step", "_init", "cgls")
