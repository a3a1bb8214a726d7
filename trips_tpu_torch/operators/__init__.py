from .blur import Blur1D, Blur2D, defocus_psf_1d, gauss_psf_1d, gauss_psf_2d
from .derivatives import (CenteredSpaceTimeDerivative, FirstDerivative1D,
                          FirstDerivative2D, SpaceTimeDerivative,
                          first_derivative_2d_matrix, first_derivative_matrix,
                          spacetime_derivative_matrix)
from .fan_shear import ShearFanProjector
from .framelet import FrameletOperator, analysis_matrix
from .projector_op import OnTheFlyFanProjector, OnTheFlyParallelProjector
from .shear_projector import ShearStackParallelProjector, shear_stack_matrix
from .weights import (CenteredDerivative2D, gs_weights, iso_tv_weights,
                      smoothed_holder_weights)

__all__ = ["Blur1D", "Blur2D", "CenteredDerivative2D",
           "CenteredSpaceTimeDerivative", "FirstDerivative1D",
           "FirstDerivative2D", "FrameletOperator", "OnTheFlyFanProjector",
           "OnTheFlyParallelProjector", "ShearFanProjector",
           "ShearStackParallelProjector", "SpaceTimeDerivative",
           "analysis_matrix", "defocus_psf_1d", "first_derivative_2d_matrix",
           "first_derivative_matrix", "gauss_psf_1d", "gauss_psf_2d",
           "gs_weights", "iso_tv_weights", "shear_stack_matrix",
           "smoothed_holder_weights", "spacetime_derivative_matrix"]
