"""gym-supplychain-tpu-torch: gym-supplychain-tpu on PyTorch, with
hand-written CUDA kernels for Hopper (H100).

Two slices are ported.  Rollouts: batched supply-chain and beer-game
environments stepped in lockstep with auto-reset (``envs.vector``), their
eager step engines (``core``), Philox random streams (``rng.device``) and
whole-episode trajectory collection (``ops``).  Training: the tanh-Gaussian
actor-critic (``models.policy``), PPO with fused collection and the fused
update kernel (``learn.ppo``) and the train CLI (``python -m
gym_supplychain_tpu_torch.learn.train``).  The JAX package
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
from .envs.presets import BeerGameSpec, beergame_v0, linear_chain, ntom_chain

_REGISTRY = {
    "supplychain-linear-v0": linear_chain,
    "supplychain-ntom-v0": ntom_chain,
    "beergame-v0": beergame_v0,
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
