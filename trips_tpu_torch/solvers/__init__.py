"""Solvers with the reference's (x, info) outputs (trips/solvers/*), and
the all-on-device fused solvers."""
from .cgls import CGLS
from .direct import Tikhonov, tGSVD_sol, tSVD_sol
from .fused import fused_gks, fused_hybrid_lsqr, fused_mmgks
from .fused_info import (fused_gks_info, fused_hybrid_gmres_info,
                         fused_hybrid_lsqr_info, fused_mmgks_info)
from .gks import GKS
from .hybrid import Hybrid_GMRES, Hybrid_LSQR
from .mmgks import MMGKS
from .projection import GMRES, Arnoldi_Tikhonov, Golub_Kahan_Tikhonov

__all__ = ["CGLS", "fused_gks", "fused_gks_info", "fused_hybrid_gmres_info",
           "fused_hybrid_lsqr", "fused_hybrid_lsqr_info", "fused_mmgks",
           "fused_mmgks_info", "GKS", "GMRES", "Arnoldi_Tikhonov",
           "Golub_Kahan_Tikhonov", "Hybrid_GMRES", "Hybrid_LSQR", "MMGKS",
           "Tikhonov", "tGSVD_sol", "tSVD_sol"]
