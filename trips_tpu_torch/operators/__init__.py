from .fan_shear import ShearFanProjector
from .projector_op import OnTheFlyFanProjector, OnTheFlyParallelProjector
from .shear_projector import ShearStackParallelProjector, shear_stack_matrix

__all__ = ["OnTheFlyFanProjector", "OnTheFlyParallelProjector",
           "ShearFanProjector", "ShearStackParallelProjector",
           "shear_stack_matrix"]
