from .checkpoint import CheckpointCallback, load_state, save_state
from .images import image_to_new_size, interp2linear

__all__ = ["CheckpointCallback", "image_to_new_size", "interp2linear",
           "load_state", "save_state"]
