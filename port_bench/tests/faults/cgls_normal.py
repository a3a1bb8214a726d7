"""The ``cgls_normal`` entry's faults, planted in ``krylov/cgls.py``."""
from ._common import krylov_faults


def faults():
    return krylov_faults("_cgn_step", "_cgn_init", "cgls_normal")
