"""Benchmark of fast_plaid_tpu_torch on one H100 (see BENCHMARK.json)."""
