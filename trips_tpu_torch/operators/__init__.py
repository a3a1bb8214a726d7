from .derivatives import (CenteredSpaceTimeDerivative, FirstDerivative1D,
                          FirstDerivative2D, SpaceTimeDerivative,
                          first_derivative_2d_matrix, first_derivative_matrix,
                          spacetime_derivative_matrix)
from .fan_shear import ShearFanProjector
from .projector_op import OnTheFlyFanProjector, OnTheFlyParallelProjector
from .shear_projector import ShearStackParallelProjector, shear_stack_matrix
from .weights import (CenteredDerivative2D, gs_weights, iso_tv_weights,
                      smoothed_holder_weights)

__all__ = ["CenteredDerivative2D", "CenteredSpaceTimeDerivative",
           "FirstDerivative1D", "FirstDerivative2D", "OnTheFlyFanProjector",
           "OnTheFlyParallelProjector", "ShearFanProjector",
           "ShearStackParallelProjector", "SpaceTimeDerivative",
           "first_derivative_2d_matrix", "first_derivative_matrix",
           "gs_weights", "iso_tv_weights", "shear_stack_matrix",
           "smoothed_holder_weights", "spacetime_derivative_matrix"]
