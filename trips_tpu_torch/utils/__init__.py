from .checkpoint import CheckpointCallback, load_state, save_state
from .gsvd import csd, gsvd, gsvd_device
from .helpers import (convert_image_for_trips, plot_recstructions_series,
                      plot_singular_values, plot_singular_vectors,
                      plot_sinograms)
from .images import build_x_true, image_to_new_size, interp2linear, load_image_mat
from .telemetry import SolverTrace, Timer, device_busy_ms, profile
from .validation import (check_noise_level, check_noise_type,
                         check_operator_type, check_Regparam, is_identity,
                         operator_qr, operator_svd, soft_thresh)

__all__ = ["CheckpointCallback", "SolverTrace", "Timer", "build_x_true",
           "check_Regparam", "check_noise_level", "check_noise_type",
           "check_operator_type", "convert_image_for_trips", "csd",
           "device_busy_ms", "gsvd",
           "gsvd_device", "image_to_new_size", "interp2linear",
           "is_identity", "load_image_mat", "load_state", "operator_qr",
           "operator_svd", "plot_recstructions_series",
           "plot_singular_values", "plot_singular_vectors", "plot_sinograms",
           "profile", "save_state", "soft_thresh"]
