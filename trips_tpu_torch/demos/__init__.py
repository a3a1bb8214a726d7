"""The port's twins of ``demos/`` (run as ``python3 -m
trips_tpu_torch.demos.<name>``; ``--device cpu`` runs them without a
card)."""
