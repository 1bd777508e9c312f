"""Episodes of the plain env under the three ways the program acts.

* ``collect_random``: uniform actions drawn with the env's inputs, as the
  collect call's ``random`` mode draws them: each step's Philox row holds A
  action uniforms, then K lead-time uniforms (stochastic lead-times), then
  R*P demand uniforms, under the call's 64-bit seed.
* ``collect_policy``: the sampled tanh-Gaussian policy, as the trainer's
  collection draws it: 2A noise uniforms first (Box-Muller of uniforms i
  and A + i), then the lead-time and demand uniforms.
* ``greedy_returns``: ``tanh(mu)`` over an episode's tables drawn as the
  evaluator draws them: one Philox row a period 0..T under the episode key
  ``(seed, n)``, K lead-time uniforms then R*P demand uniforms; period t's
  lead-times serve the step from t - 1.

Every episode starts fresh and runs T steps; the demand row after the last
step only feeds the terminal observation, so it repeats the last row.
"""
from __future__ import annotations

import torch

from .chain import Chain
from .env import Env
from .philox import (box_muller, leadtime_cdf, leadtimes, philox_uniform,
                     seed_key, uniform_demand)
from .policy import forward, logp

__all__ = ["collect_random", "collect_policy", "greedy_returns"]


def _rows(ch: Chain, key, n_lead: int, B: int, device, dtype):
    """(uniforms ahead of the env's [T, n_lead, B], demands [T + 1, R, P,
    B], lead-times [T, K, B] or None) from the rows of steps 0..T-1."""
    K = ch.K if ch.stochastic else 0
    u = philox_uniform(key, range(ch.T), n_lead + K + ch.R * ch.P, B, device)
    dem = uniform_demand(u[:, n_lead + K:], ch.dem_min, ch.dem_max)
    dem = dem.reshape(ch.T, ch.R, ch.P, B)
    lt = (leadtimes(u[:, n_lead:n_lead + K],
                    leadtime_cdf(ch.Lavg - 1, ch.Lmax))
          if ch.stochastic else None)
    return u[:, :n_lead], torch.cat([dem, dem[-1:]]).to(dtype), lt


@torch.no_grad()
def collect_random(ch: Chain, seed: int, B: int, device,
                   dtype=torch.float32):
    """-> (obs [T, O, B], reward [T, B]) in ``dtype``."""
    env = Env(ch, device, dtype)
    u, dem, lt = _rows(ch, seed_key(seed), ch.A, B, device, dtype)
    act = (2.0 * u - 1.0).to(dtype)
    obs = torch.empty((ch.T, ch.obs_dim, B), dtype=dtype, device=device)
    rew = torch.empty((ch.T, B), dtype=dtype, device=device)
    st = env.reset(B)
    for t in range(ch.T):
        obs[t] = env.obs(st, dem)
        st, rew[t] = env.step(st, act[t], dem, lt)
    return obs, rew


@torch.no_grad()
def collect_policy(ch: Chain, flat, seed: int, B: int, device):
    """-> (obs [T, O, B], pre [T, A, B], logp [T, B], value [T, B],
    reward [T, B]) of the sampled policy ``flat``."""
    A = ch.A
    env = Env(ch, device)
    u, dem, lt = _rows(ch, seed_key(seed), 2 * A, B, device, torch.float32)
    eps = box_muller(u[:, :A], u[:, A:])
    out = [torch.empty((ch.T, n, B), device=device)
           for n in (ch.obs_dim, A, 1, 1, 1)]
    st = env.reset(B)
    for t in range(ch.T):
        o = env.obs(st, dem)
        mu, log_std, value = forward(flat, o)
        pre = mu + torch.exp(log_std) * eps[t]
        out[0][t], out[1][t] = o, pre
        out[2][t, 0], out[3][t, 0] = logp(pre, mu, log_std), value
        st, out[4][t, 0] = env.step(st, torch.tanh(pre), dem, lt)
    return out[0], out[1], out[2][:, 0], out[3][:, 0], out[4][:, 0]


@torch.no_grad()
def greedy_returns(ch: Chain, flat, ep_key, B: int, device):
    """-> each lane's return [B] under ``tanh(mu)`` over the episode of
    key ``ep_key = (seed, n)``."""
    K = ch.K if ch.stochastic else 0
    env = Env(ch, device)
    u = philox_uniform(ep_key, range(ch.T + 1), K + ch.R * ch.P, B, device)
    dem = uniform_demand(u[:, K:], ch.dem_min, ch.dem_max).reshape(
        ch.T + 1, ch.R, ch.P, B)
    lt = (leadtimes(u[1:, :K], leadtime_cdf(ch.Lavg - 1, ch.Lmax))
          if ch.stochastic else None)
    rew = torch.empty((ch.T, B), device=device)
    st = env.reset(B)
    for t in range(ch.T):
        mu, _, _ = forward(flat, env.obs(st, dem), critic=False)
        st, rew[t] = env.step(st, torch.tanh(mu), dem, lt)
    return rew.sum(dim=0)
