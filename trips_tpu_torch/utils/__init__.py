from .checkpoint import CheckpointCallback, load_state, save_state
from .gsvd import csd, gsvd, gsvd_device
from .images import build_x_true, image_to_new_size, interp2linear, load_image_mat
from .validation import (check_noise_level, check_noise_type,
                         check_operator_type, check_Regparam, is_identity,
                         operator_qr, operator_svd, soft_thresh)

__all__ = ["CheckpointCallback", "build_x_true", "check_Regparam",
           "check_noise_level", "check_noise_type", "check_operator_type",
           "csd", "gsvd", "gsvd_device", "image_to_new_size", "interp2linear",
           "is_identity", "load_image_mat", "load_state", "operator_qr",
           "operator_svd", "save_state", "soft_thresh"]
