"""gym-supplychain-tpu-torch: gym-supplychain-tpu on PyTorch, with
hand-written CUDA kernels for Hopper (H100).

Five slices are ported.  Rollouts: batched supply-chain and beer-game
environments stepped in lockstep with auto-reset (``envs.vector``), their
eager step engines (``core``), Philox random streams (``rng.device``) and
whole-episode trajectory collection (``ops``).  Training: the tanh-Gaussian
actor-critic (``models.policy``), PPO with fused collection and the fused
update kernel (``learn.ppo``) and the train CLI (``python -m
gym_supplychain_tpu_torch.learn.train``) with checkpoints
(``utils.checkpoint``).  Evaluation: greedy rollouts through the episode
kernel or the batched env (``learn.evaluate`` and its CLI) and the
base-stock baselines (``learn.heuristics``, ``learn.compare_baseline``).
Large topologies: the N-per-stage and multi-product presets, trajectory
collection for chains of up to 64 nodes (``ops.supplychain_dense``) and its
benchmark (``python -m
gym_supplychain_tpu_torch.benchmarks.large_topologies``), and the
rewards-only beer-game sweep (``ops.beergame_episode``).  Demand
processes: every supply-chain id of the JAX registry (the seasonal
2-per-stage chain, the per-product demand variants, the one-one-N chain,
the generic ``supplychain-v0``), their uniform, normal and seasonal demand
drawn inside the collect kernels (``rng.device.demand_from_uniforms``).
Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU.  The JAX package ``gym_supplychain_tpu`` is the reference the
port is tested against; this package never imports it, nor jax.

>>> import gym_supplychain_tpu_torch as sct
>>> from gym_supplychain_tpu_torch.ops.supplychain_collect import (
...     make_supplychain_collect)
>>> cc = sct.make_chain("supplychain-ntom-v0")
>>> run = make_supplychain_collect(cc, cc.T, 4096, mode="random",
...                                episodes=8, device="cuda")
>>> obs, reward = run(0)            # obs [8*360, obs_dim, 4096]
"""
from .core.compile import CompiledChain, DemandConfig, compile_chain
from .envs.presets import (BeerGameSpec, beergame_v0, linear_chain,
                           multiproduct_chain, multiproduct_inccosts_chain,
                           multiproduct_v1_chain,
                           multiproduct_v1_inccosts_chain, nperstage_chain,
                           ntom_chain, oneonen_chain, supplychain_chain,
                           twoperstage_chain, twoperstage_seasonal_chain)

_REGISTRY = {
    "supplychain-linear-v0": linear_chain,
    "supplychain-ntom-v0": ntom_chain,
    "supplychain-2perstage-v0": twoperstage_chain,
    "sc-2perstage-v0": twoperstage_chain,
    "sc-2perstage-multiproduct-v0": multiproduct_chain,
    "sc-Nperstage-multiproduct-v0": nperstage_chain,
    "sc-2perstage-multiproduct-inccosts-v0": multiproduct_inccosts_chain,
    "beergame-v0": beergame_v0,
    "supplychain-v0": supplychain_chain,
    "sc-2perstage-seasonal-v0": twoperstage_seasonal_chain,
    "sc-2perstage-multiproduct-v1": multiproduct_v1_chain,
    "sc-2perstage-multiproduct-inccosts-v1": multiproduct_v1_inccosts_chain,
    "supplychain-oneonen-v0": oneonen_chain,
}


def registry():
    """The environment ids this package builds."""
    return tuple(_REGISTRY)


def make_chain(env_id: str, **kw):
    """The configuration of ``env_id``: a ``CompiledChain`` for the supply
    chains, a ``BeerGameSpec`` for the beer game."""
    try:
        build = _REGISTRY[env_id]
    except KeyError:
        raise KeyError(f"Unknown env id {env_id!r}; known: {sorted(_REGISTRY)}")
    return build(**kw)


__all__ = ["make_chain", "registry", "compile_chain", "CompiledChain",
           "DemandConfig", "BeerGameSpec"]
