from . import phantoms
from .projector import fan_beam_matrix, parallel_beam_matrix
from .tomography import Tomography, device_sparse_operator

__all__ = ["Tomography", "device_sparse_operator", "fan_beam_matrix",
           "parallel_beam_matrix", "phantoms"]
