"""The benchmark of the PyTorch and CUDA port (``trips_tpu_torch``): CT
reconstructions on one card, a closed loop of scans per cell. Run a cell
with ``python3 -m port_bench.run`` (see ``run.py``); the cells, metrics
and bounds are in ``BENCHMARK.json`` at the root of the repository."""
