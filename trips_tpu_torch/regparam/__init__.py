from .dp import discrepancy_principle
from .gcv import generalized_crossvalidation
from .lcurve import curvature, l_curve
from .utils import poisson_delta

__all__ = [
    "discrepancy_principle",
    "generalized_crossvalidation",
    "curvature",
    "l_curve",
    "poisson_delta",
]
