"""Solvers with the reference's (x, info) outputs (trips/solvers/*)."""
from .cgls import CGLS
from .gks import GKS
from .hybrid import Hybrid_GMRES, Hybrid_LSQR
from .mmgks import MMGKS
from .projection import GMRES, Arnoldi_Tikhonov, Golub_Kahan_Tikhonov

__all__ = ["CGLS", "GKS", "GMRES", "Arnoldi_Tikhonov", "Golub_Kahan_Tikhonov",
           "Hybrid_GMRES", "Hybrid_LSQR", "MMGKS"]
