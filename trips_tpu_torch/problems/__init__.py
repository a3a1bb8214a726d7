from . import phantoms
from .deblurring import Deblurring1D, Deblurring2D
from .dynamic import (generate_crossPhantom, generate_emoji, generate_stempo,
                      generate_synthetic_dynamic)
from .projector import fan_beam_matrix, parallel_beam_matrix
from .tomography import Tomography, device_sparse_operator

__all__ = ["Deblurring1D", "Deblurring2D", "Tomography",
           "device_sparse_operator", "fan_beam_matrix",
           "generate_crossPhantom", "generate_emoji", "generate_stempo",
           "generate_synthetic_dynamic", "parallel_beam_matrix", "phantoms"]
