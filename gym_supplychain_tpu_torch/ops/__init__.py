"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch version.

* ``supplychain_collect``: supply-chain trajectory collection (replaces the
  TPU kernel ``make_supplychain_collect_pallas``);
* ``beergame_collect``: beer-game trajectory collection (replaces
  ``make_beergame_collect_pallas``);
* ``ppo_update``: the PPO update's forward, loss and backward (replaces
  ``make_ppo_update_grads``).

The CUDA sources build with nvcc at first use (``_build``), never at import.
"""
