"""Actor-critic MLP for the continuous supply-chain action space.

The counterpart of ``gym_supplychain_tpu/models/policy.py``.  The parameter
layout is the JAX package's: every layer holds ``w [out, in]`` and
``b [out, 1]``, and inputs are batch-trailing, ``x [obs_dim, B]``, so a
layer is ``w @ x + b``.  ``params_from_jax`` / ``params_to_numpy`` carry a
parameter tree across, so the tests run both packages from the same
weights.

The flat order of ``ActorCritic.flat()`` is the JAX package's
``_flat_actor_critic`` (``ops/supplychain_pallas.py``): actor trunk
``(w, b)`` pairs and the ``mu`` head, critic trunk and the ``v`` head, then
``log_std``.  The CUDA kernels take their weights in that order.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["MLPConfig", "ActorCritic", "actor_critic_forward",
           "tanh_gaussian_logp", "tanh_gaussian_terms",
           "sample_tanh_gaussian", "softplus", "flat_params", "split_params",
           "params_from_jax", "params_to_numpy", "LOG_STD_MIN",
           "LOG_STD_MAX"]

LOG_STD_MIN, LOG_STD_MAX = -5.0, 2.0


class MLPConfig(NamedTuple):
    obs_dim: int
    act_dim: int
    hidden: Tuple[int, ...] = (128, 128)


class Dense(nn.Module):
    """``w [out, in] @ x [in, B] + b [out, 1]``."""

    def __init__(self, n_out: int, n_in: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros((n_out, n_in)))
        self.b = nn.Parameter(torch.zeros((n_out, 1)))


class ActorCritic(nn.Module):
    """Tanh-MLP actor (``mu`` head, state-independent ``log_std``) and
    critic (``v`` head) over separate trunks of widths ``cfg.hidden``.

    Initialised as ``init_actor_critic`` does: ``w ~ N(0, 1) * scale /
    sqrt(n_in)`` (scale 1, 0.01 for ``mu``), zero biases, ``log_std = -0.5``,
    in float32; the draws come from ``generator`` on the CPU, so a seed
    gives the same weights on every device.
    """

    def __init__(self, cfg: MLPConfig, generator: torch.Generator = None,
                 device="cuda"):
        super().__init__()
        self.cfg = MLPConfig(cfg.obs_dim, cfg.act_dim, tuple(cfg.hidden))
        if not self.cfg.hidden:
            raise ValueError("the actor-critic needs at least one hidden layer")
        self.actor = nn.ModuleList()
        n_in = cfg.obs_dim
        for h in self.cfg.hidden:
            self.actor.append(Dense(h, n_in))
            n_in = h
        self.mu = Dense(cfg.act_dim, n_in)
        self.critic = nn.ModuleList()
        n_in = cfg.obs_dim
        for h in self.cfg.hidden:
            self.critic.append(Dense(h, n_in))
            n_in = h
        self.v = Dense(1, n_in)
        self.log_std = nn.Parameter(torch.full((cfg.act_dim, 1), -0.5))
        with torch.no_grad():
            for layer, scale in self._init_order():
                n_out, n_in = layer.w.shape
                w = torch.randn((n_out, n_in), generator=generator)
                layer.w.copy_(w * scale / math.sqrt(n_in))
        self.to(device)

    def _init_order(self):
        for a, c in zip(self.actor, self.critic):
            yield a, 1.0
            yield c, 1.0
        yield self.mu, 0.01
        yield self.v, 1.0

    def flat(self):
        """The parameters in the ``_flat_actor_critic`` order."""
        flat = []
        for layer in (*self.actor, self.mu, *self.critic, self.v):
            flat += [layer.w, layer.b]
        return flat + [self.log_std]

    def forward(self, obs):
        return actor_critic_forward(self, obs)


def flat_params(params):
    """An ``ActorCritic`` or a flat list in ``_flat_actor_critic`` order ->
    that flat list."""
    if isinstance(params, ActorCritic):
        return params.flat()
    flat = list(params)
    if len(flat) < 9 or (len(flat) - 5) % 4:
        raise ValueError(f"{len(flat)} tensors is no flat actor-critic "
                         "(4 * n_hidden + 5)")
    return flat


def split_params(params):
    """(actor [(w, b)], mu (w, b), critic [(w, b)], v (w, b), log_std)."""
    flat = flat_params(params)
    nL = (len(flat) - 5) // 4
    pairs = [(flat[2 * i], flat[2 * i + 1]) for i in range(2 * nL + 2)]
    return (pairs[:nL], pairs[nL], pairs[nL + 1:2 * nL + 1], pairs[2 * nL + 1],
            flat[-1])


def actor_critic_forward(params, obs):
    """obs [obs_dim, B] -> (mu [A, B], log_std [A, 1], value [B]).

    ``params`` is an ``ActorCritic`` or its flat list; every tensor is used
    in its own dtype (the JAX package's ``compute_dtype=None``)."""
    actor, mu_l, critic, v_l, log_std = split_params(params)
    a = c = obs
    for w, b in actor:
        a = torch.tanh(w @ a + b)
    for w, b in critic:
        c = torch.tanh(w @ c + b)
    mu = mu_l[0] @ a + mu_l[1]
    v = (v_l[0] @ c + v_l[1])[0]
    return mu, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX), v


def softplus(x):
    """``max(x, 0) + log1p(exp(-|x|))``, as the TPU kernels compute it."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def tanh_gaussian_terms(pre, mu, log_std, std):
    """Per-dimension log-density terms ``[A, B]`` of tanh(N(mu, std)) at
    ``tanh(pre)``, in the op order the CUDA collect kernel follows."""
    z = (pre - mu) / std
    g = -0.5 * (z * z + 2 * log_std + math.log(2 * math.pi))
    # tanh change of variables: log(1 - tanh(x)^2) = 2(log2 - x - softplus(-2x))
    corr = 2 * (math.log(2.0) - pre - softplus(-2 * pre))
    return g - corr


def tanh_gaussian_logp(pre_tanh, mu, log_std):
    """Log-density of tanh(N(mu, std)) at tanh(pre_tanh), summed over the
    action axis -> [B]."""
    return tanh_gaussian_terms(pre_tanh, mu, log_std,
                               torch.exp(log_std)).sum(dim=0)


def sample_tanh_gaussian(generator: torch.Generator, mu, log_std):
    """Tanh-squashed Gaussian sample for the Box(-1, 1) action space.
    ``generator`` lives on ``mu``'s device.  Returns (action, log-prob)."""
    eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype,
                      device=mu.device)
    pre = mu + torch.exp(log_std) * eps
    return torch.tanh(pre), tanh_gaussian_logp(pre, mu, log_std)


def params_from_jax(tree, device="cuda") -> ActorCritic:
    """An ``ActorCritic`` holding the values of an ``init_actor_critic``
    tree (numpy or JAX arrays: ``{"actor": [{"w", "b"}], "critic": [...],
    "mu", "v", "log_std"}``)."""
    hidden = tuple(int(np.shape(layer["w"])[0]) for layer in tree["actor"])
    obs_dim = int(np.shape(tree["actor"][0]["w"])[1])
    act_dim = int(np.shape(tree["mu"]["w"])[0])
    model = ActorCritic(MLPConfig(obs_dim, act_dim, hidden), device="cpu")
    src = []
    for layer in tree["actor"]:
        src += [layer["w"], layer["b"]]
    src += [tree["mu"]["w"], tree["mu"]["b"]]
    for layer in tree["critic"]:
        src += [layer["w"], layer["b"]]
    src += [tree["v"]["w"], tree["v"]["b"], tree["log_std"]]
    with torch.no_grad():
        for p, x in zip(model.flat(), src):
            x = np.array(x, np.float32)
            if x.shape != tuple(p.shape):
                raise ValueError(f"shape {x.shape}, expected {tuple(p.shape)}")
            p.copy_(torch.from_numpy(x))
    return model.to(device)


def params_to_numpy(params) -> dict:
    """The JAX package's parameter tree, as float32 numpy arrays (copies,
    not views of the parameters)."""
    actor, mu_l, critic, v_l, log_std = split_params(params)

    def n(x):
        return x.detach().cpu().numpy().copy()

    return {"actor": [{"w": n(w), "b": n(b)} for w, b in actor],
            "critic": [{"w": n(w), "b": n(b)} for w, b in critic],
            "mu": {"w": n(mu_l[0]), "b": n(mu_l[1])},
            "v": {"w": n(v_l[0]), "b": n(v_l[1])},
            "log_std": n(log_std)}
