"""Benchmarks of the port (``python -m
gym_supplychain_tpu_torch.benchmarks.<name> --device cuda``)."""
