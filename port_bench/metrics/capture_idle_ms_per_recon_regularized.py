"""``capture_idle_ms_per_recon`` in the regularized cells, where it moves
``regularized_recon_per_s``."""
from .capture_idle_ms_per_recon import read  # noqa: F401
