from . import phantoms
from .deblurring import Deblurring1D, Deblurring2D
from .dynamic import (generate_crossPhantom, generate_emoji, generate_stempo,
                      generate_synthetic_dynamic)
from .gelphantom import generate_gelPhantom
from .projector import (analytic_sinogram, fan_beam_matrix,
                        parallel_beam_matrix)
from .tomography import Tomography, device_sparse_operator

__all__ = ["Deblurring1D", "Deblurring2D", "Tomography", "analytic_sinogram",
           "device_sparse_operator", "fan_beam_matrix",
           "generate_crossPhantom", "generate_emoji", "generate_gelPhantom",
           "generate_stempo",
           "generate_synthetic_dynamic", "parallel_beam_matrix", "phantoms"]
