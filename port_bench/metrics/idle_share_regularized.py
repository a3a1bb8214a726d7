"""``idle_share`` in the regularized cells, where it moves
``regularized_recon_per_s``."""
from .idle_share import read  # noqa: F401
