from .images import image_to_new_size, interp2linear

__all__ = ["image_to_new_size", "interp2linear"]
