"""gym-supplychain-tpu-torch: gym-supplychain-tpu on PyTorch, with
hand-written CUDA kernels for Hopper (H100).

Eight slices are ported.  Rollouts: batched supply-chain and beer-game
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
The bf16 learner and the beer game's learning: ``PPOConfig.learner_dtype``
(the update kernel's tensor-core bf16 mode, ``ops.ppo_update``), the beer
game's categorical PPO, greedy evaluator and order-up-to baseline
(``learn.ppo.make_beergame_ppo``, ``learn.evaluate``,
``learn.heuristics``, ``learn.compare_baseline_beergame``).  The
reference-compatible surface: the host MT19937 streams (``rng.host``, the
native generator ``native``, ``rng.gym_compat``), the vec envs' host modes,
the single envs with strict observations (``envs.single``,
``envs.presets``, ``envs.beergame``), ``make`` over every id and the
gymnasium adapters (``envs.gym_registry``).  Data-parallel training over
processes: the process group and its mesh (``parallel.mesh``), the
trainers' ``mesh=`` forms, multi-process checkpoints, device traces
(``utils.profiling.trace``), ``--multihost`` / ``--trace-dir`` in the
train CLI and the scaling benchmark (``python -m
gym_supplychain_tpu_torch.benchmarks.multihost_scaling``).  Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU.  The JAX package
``gym_supplychain_tpu`` is the reference the port is tested against; this
package never imports it, nor jax.

>>> import gym_supplychain_tpu_torch as sct
>>> from gym_supplychain_tpu_torch.ops.supplychain_collect import (
...     make_supplychain_collect)
>>> cc = sct.make_chain("supplychain-ntom-v0")
>>> run = make_supplychain_collect(cc, cc.T, 4096, mode="random",
...                                episodes=8, device="cuda")
>>> obs, reward = run(0)            # obs [8*360, obs_dim, 4096]
"""
from .core.compile import CompiledChain, DemandConfig, compile_chain
from .envs.beergame import BeerGameEnv, BeerGameEnv2
from .envs.presets import (
    BeerGameSpec, SupplyChain2perStageEnv, SupplyChain2perStageSeasonalEnv,
    SupplyChainLinearEnv, SupplyChainMultiProduct,
    SupplyChainMultiProduct_DemConfigByProd,
    SupplyChainMultiProduct_DemConfigByProd_IncCosts,
    SupplyChainMultiProduct_IncreasingCosts, SupplyChainNPerStage,
    SupplyChainNtoMEnv, SupplyChainOneOneNEnv, beergame_v0, beergame_v2,
    linear_chain, multiproduct_chain, multiproduct_inccosts_chain,
    multiproduct_v1_chain, multiproduct_v1_inccosts_chain, nperstage_chain,
    ntom_chain, oneonen_chain, supplychain_chain, twoperstage_chain,
    twoperstage_seasonal_chain)
from .envs.single import SupplyChainEnv
from .rng.host import generate_demand

# id -> (configuration builder, env class), in the JAX registry's order
_REGISTRY = {
    # reference ids
    "beergame-v0": (beergame_v0, BeerGameEnv),
    "beergame-v2": (beergame_v2, BeerGameEnv2),
    "supplychain-v0": (supplychain_chain, SupplyChainEnv),
    "sc-2perstage-v0": (twoperstage_chain, SupplyChain2perStageEnv),
    "sc-2perstage-seasonal-v0": (twoperstage_seasonal_chain,
                                 SupplyChain2perStageSeasonalEnv),
    "sc-2perstage-multiproduct-v0": (multiproduct_chain,
                                     SupplyChainMultiProduct),
    "sc-Nperstage-multiproduct-v0": (nperstage_chain, SupplyChainNPerStage),
    "sc-2perstage-multiproduct-inccosts-v0": (
        multiproduct_inccosts_chain, SupplyChainMultiProduct_IncreasingCosts),
    "sc-2perstage-multiproduct-v1": (
        multiproduct_v1_chain, SupplyChainMultiProduct_DemConfigByProd),
    "sc-2perstage-multiproduct-inccosts-v1": (
        multiproduct_v1_inccosts_chain,
        SupplyChainMultiProduct_DemConfigByProd_IncCosts),
    # the reference README's topology names
    "supplychain-linear-v0": (linear_chain, SupplyChainLinearEnv),
    "supplychain-oneonen-v0": (oneonen_chain, SupplyChainOneOneNEnv),
    "supplychain-ntom-v0": (ntom_chain, SupplyChainNtoMEnv),
    "supplychain-2perstage-v0": (twoperstage_chain, SupplyChain2perStageEnv),
}


def registry():
    """The environment ids this package builds."""
    return tuple(_REGISTRY)


def _entry(env_id: str):
    try:
        return _REGISTRY[env_id]
    except KeyError:
        raise KeyError(f"Unknown env id {env_id!r}; known: "
                       f"{sorted(_REGISTRY)}") from None


def make_chain(env_id: str, **kw):
    """The configuration of ``env_id``: a ``CompiledChain`` for the supply
    chains, a ``BeerGameSpec`` for the beer game."""
    return _entry(env_id)[0](**kw)


def make(env_id: str, **kw):
    """A single environment of ``env_id`` (the ``gym.make`` equivalent): the
    env class's keyword arguments, ``device="cpu"`` for the CPU."""
    return _entry(env_id)[1](**kw)


__all__ = [
    "make", "make_chain", "registry", "compile_chain", "CompiledChain",
    "DemandConfig", "BeerGameSpec", "BeerGameEnv", "BeerGameEnv2",
    "generate_demand", "SupplyChainEnv", "SupplyChain2perStageEnv",
    "SupplyChain2perStageSeasonalEnv", "SupplyChainMultiProduct",
    "SupplyChainMultiProduct_IncreasingCosts",
    "SupplyChainMultiProduct_DemConfigByProd",
    "SupplyChainMultiProduct_DemConfigByProd_IncCosts",
    "SupplyChainNPerStage", "SupplyChainLinearEnv", "SupplyChainOneOneNEnv",
    "SupplyChainNtoMEnv",
]
