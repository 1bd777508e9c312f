"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch version.

* ``supplychain_collect``: supply-chain trajectory collection (replaces the
  TPU kernel ``make_supplychain_collect_pallas``);
* ``beergame_collect``: beer-game trajectory collection (replaces
  ``make_beergame_collect_pallas``);
* ``ppo_update``: the PPO update's forward, loss and backward (replaces
  ``make_ppo_update_grads``);
* ``supplychain_episode``: one rewards-only episode, greedy policy,
  Philox or table actions (replaces ``make_supplychain_episode_pallas``
  and ``make_supplychain_policy_rollout_pallas``);
* ``supplychain_dense``: trajectory collection for large chains (replaces
  ``make_supplychain_dense_collect_pallas``);
* ``beergame_episode``: one rewards-only beer-game episode (replaces
  ``beergame_episode_pallas``);
* ``episode_tables``: one episode's demand and lead-time tables from
  Philox in one launch (``rng/device.py``'s eager draw is its plain
  version; replaces no TPU kernel).

The CUDA sources build with nvcc at first use (``_build``), never at import.
"""
