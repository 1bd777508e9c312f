"""The tanh-Gaussian actor-critic, written plainly.

Parameters are a flat list: the actor trunk's ``(w [out, in], b [out, 1])``
pairs and the ``mu`` head, the critic trunk's pairs and the ``v`` head,
then ``log_std [A, 1]``.  Inputs are batch-trailing, ``x [in, B]``, and a
layer is ``tanh(w @ x + b)`` (the heads without the tanh).  Matmuls run in
whatever precision the caller has set: TF32 off for the configuration,
on for the control.
"""
from __future__ import annotations

import math

import torch

__all__ = ["init_params", "forward", "logp_terms", "logp", "LOG_STD"]

LOG_STD = (-5.0, 2.0)      # log_std is clipped to this range


def init_params(O: int, A: int, hidden, seed: int, device):
    """The trainer's initial weights for ``seed``: from a CPU generator
    seeded ``seed``, ``w ~ N(0, 1) * scale / sqrt(in)`` drawn actor then
    critic layer by layer, then ``mu`` (scale 0.01), then ``v``; zero
    biases; ``log_std = -0.5``.  Returns ``(flat, generator)``: the
    trainer draws its kernel seeds from the same generator afterwards."""
    gen = torch.Generator().manual_seed(int(seed))
    dims = [O, *hidden]
    actor, critic = [], []

    def layer(n_out, n_in, scale):
        w = torch.randn((n_out, n_in), generator=gen) * scale / math.sqrt(n_in)
        return [w, torch.zeros((n_out, 1))]

    for n_in, n_out in zip(dims, dims[1:]):
        actor += layer(n_out, n_in, 1.0)
        critic += layer(n_out, n_in, 1.0)
    mu = layer(A, dims[-1], 0.01)
    v = layer(1, dims[-1], 1.0)
    flat = actor + mu + critic + v + [torch.full((A, 1), -0.5)]
    return [p.to(device) for p in flat], gen


def _split(flat):
    nL = (len(flat) - 5) // 4
    pairs = [(flat[2 * i], flat[2 * i + 1]) for i in range(2 * nL + 2)]
    return pairs[:nL], pairs[nL], pairs[nL + 1:2 * nL + 1], pairs[2 * nL + 1], \
        flat[-1]


def forward(flat, obs, critic: bool = True):
    """obs [O, B] -> (mu [A, B], clipped log_std [A, 1], value [B] or
    None)."""
    actor, (wm, bm), trunk_c, (wv, bv), log_std = _split(flat)
    a = obs
    for w, b in actor:
        a = torch.tanh(w @ a + b)
    mu = wm @ a + bm
    value = None
    if critic:
        c = obs
        for w, b in trunk_c:
            c = torch.tanh(w @ c + b)
        value = (wv @ c + bv)[0]
    return mu, torch.clamp(log_std, *LOG_STD), value


def _softplus(x):
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def logp_terms(pre, mu, log_std):
    """Per-dimension log-density ``[A, B]`` of tanh(N(mu, exp(log_std))) at
    tanh(pre)."""
    z = (pre - mu) / torch.exp(log_std)
    gauss = -0.5 * (z * z + 2 * log_std + math.log(2 * math.pi))
    # log(1 - tanh(x)^2) = 2 (log 2 - x - softplus(-2x))
    return gauss - 2 * (math.log(2.0) - pre - _softplus(-2 * pre))


def logp(pre, mu, log_std):
    return logp_terms(pre, mu, log_std).sum(dim=0)
