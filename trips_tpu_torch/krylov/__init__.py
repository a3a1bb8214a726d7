from .arnoldi import arnoldi, arnoldi_extend, arnoldi_init
from .cgls import (cgls, cgls_fixed, cgls_history, cgls_normal,
                   cgls_normal_fixed)
from .golub_kahan import gk_init, golub_kahan, golub_kahan_extend
from .lsqr import lsqr

__all__ = ["arnoldi", "arnoldi_extend", "arnoldi_init", "cgls", "cgls_fixed",
           "cgls_history", "cgls_normal", "cgls_normal_fixed", "gk_init",
           "golub_kahan", "golub_kahan_extend", "lsqr"]
