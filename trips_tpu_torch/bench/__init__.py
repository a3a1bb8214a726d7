"""Measurement helpers of the port (counterpart of ``trips_tpu/bench``)."""
