"""The benchmark of the PyTorch and CUDA port (``gym_supplychain_tpu_torch``).

``python3 -m perfbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once (``run.py``)."""
