"""The benchmark of gatv2_tpu_torch on the H100 (see BENCHMARK.json at
the repository root and run.py)."""
