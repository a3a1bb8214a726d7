"""See port_bench.harness."""
