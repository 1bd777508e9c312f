"""Optional Gymnasium integration.

The counterpart of ``gym_supplychain_tpu/envs/gym_registry.py``: a
Gymnasium ``Env`` adapter (5-tuple step API, ``reset(seed=...)``), a vector
adapter over the batched env, and the registration of every environment id
under the ``gym_supplychain_tpu_torch/`` namespace, so
``gymnasium.make("gym_supplychain_tpu_torch/sc-2perstage-v0",
device="cpu")`` works where gymnasium is installed.  ``gymnasium`` is
imported only inside these functions and constructors; the native 4-tuple
envs remain the parity surface.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["GymnasiumAdapter", "GymnasiumVectorAdapter", "register_gymnasium"]

NAMESPACE = "gym_supplychain_tpu_torch"


def _adapter_class():
    """Define ``GymnasiumAdapter`` on ``gymnasium.Env``, importing
    gymnasium only now."""
    import gymnasium

    class GymnasiumAdapter(gymnasium.Env):
        """Wrap a parity env (4-tuple API) as a ``gymnasium.Env``:
        ``make(env_id, **kwargs)`` behind the gymnasium API."""

        metadata = {"render_modes": ["human"]}

        def __init__(self, env_id: str, **kwargs):
            from .. import make

            self._env = make(env_id, **kwargs)
            spaces = gymnasium.spaces
            self._obs_dtype = np.float32
            if hasattr(self._env, "action_space"):
                a = self._env.action_space
                o = self._env.observation_space
                if hasattr(a, "nvec"):
                    self.action_space = spaces.MultiDiscrete(a.nvec)
                    self.observation_space = spaces.MultiDiscrete(o.nvec)
                    self._obs_dtype = np.int64
                else:
                    self.action_space = spaces.Box(-1.0, 1.0, a.shape,
                                                   np.float32)
                    self.observation_space = spaces.Box(-1.0, 1.0, o.shape,
                                                        np.float32)

        def reset(self, *, seed: Optional[int] = None, options=None):
            if seed is not None and hasattr(self._env, "seed"):
                self._env.seed(seed)
            obs = self._env.reset()
            return np.asarray(obs, self._obs_dtype), {}

        def step(self, action):
            obs, reward, done, info = self._env.step(np.asarray(action))
            # fixed-horizon episodes: termination at T, never truncation
            # (the reference has no truncation concept,
            # supplychain_env.py:742)
            return (np.asarray(obs, self._obs_dtype), float(reward),
                    bool(done), False, info)

        def render(self):
            return self._env.render()

        def close(self):
            self._env.close()

    GymnasiumAdapter.__module__ = __name__
    GymnasiumAdapter.__qualname__ = "GymnasiumAdapter"
    return GymnasiumAdapter


def __getattr__(name):
    # ``GymnasiumAdapter`` subclasses ``gymnasium.Env``, so it is defined at
    # its first use, not when this module is imported
    if name == "GymnasiumAdapter":
        cls = globals()[name] = _adapter_class()
        return cls
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class GymnasiumVectorAdapter:
    """The batched env through the ``gymnasium.vector`` conventions
    (batch-first arrays, auto-reset every ``T`` steps, 5-tuple step).  The
    batch-trailing layout stays on the env's device; only the returned host
    arrays are transposed.

    >>> vec = GymnasiumVectorAdapter("supplychain-ntom-v0", num_envs=4096)
    >>> obs, info = vec.reset(seed=0)          # obs [4096, obs_dim]
    >>> obs, r, term, trunc, info = vec.step(actions)   # actions [4096, A]
    """

    def __init__(self, env_id: str, num_envs: int = 1024, device="cuda",
                 **kwargs):
        import gymnasium
        import torch
        from .. import make_chain
        from .vector import VecSupplyChainEnv

        cc = make_chain(env_id, **kwargs)
        if not hasattr(cc, "obs_dim"):
            raise ValueError(f"{env_id!r} is not a supply-chain env; the "
                             "vector adapter covers the Box-action family")
        self.num_envs = num_envs
        self._cc, self._device = cc, torch.device(device)
        self._vec = VecSupplyChainEnv(cc=cc, batch_size=num_envs,
                                      device=self._device)
        A, O = cc.A, cc.obs_dim
        Box = gymnasium.spaces.Box
        self.single_action_space = Box(-1., 1., (A,), np.float32)
        self.single_observation_space = Box(-1., 1., (O,), np.float32)
        self.action_space = Box(-1., 1., (num_envs, A), np.float32)
        self.observation_space = Box(-1., 1., (num_envs, O), np.float32)

    def reset(self, *, seed: Optional[int] = None, options=None):
        from .vector import VecSupplyChainEnv

        if seed is not None:
            self._vec = VecSupplyChainEnv(
                cc=self._cc, batch_size=self.num_envs, seed=seed,
                device=self._device)
        obs = self._vec.reset()
        return obs.T.cpu().numpy(), {}

    def step(self, actions):
        import torch

        a = torch.as_tensor(np.asarray(actions, np.float32).T,
                            device=self._device)
        out = self._vec.step(a)
        term = np.full(self.num_envs, bool(out.done))
        trunc = np.zeros(self.num_envs, bool)
        return (out.obs.T.cpu().numpy(), out.reward.cpu().numpy(), term,
                trunc, {})

    def close(self):
        pass


def register_gymnasium() -> bool:
    """Register every id with gymnasium under ``gym_supplychain_tpu_torch/``
    (idempotent); returns whether gymnasium is installed."""
    try:
        from gymnasium.envs.registration import register, registry
    except ImportError:
        return False
    from .. import registry as ids
    for env_id in ids():
        full = f"{NAMESPACE}/{env_id}"
        if full in registry:
            continue
        register(id=full,
                 entry_point=f"{__name__}:GymnasiumAdapter",
                 kwargs={"env_id": env_id})
    return True
