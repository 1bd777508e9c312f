"""The fused trainer's iterations, written plainly.

An iteration collects one whole episode of every lane with the sampled
policy (``collect_policy``) under a 64-bit seed drawn from the trainer's
CPU generator, scales the rewards, runs GAE with the episode's end as the
only terminal (no bootstrap), normalizes the advantages over the batch
(population std + 1e-8), and takes ``epochs`` full-batch steps: the
clipped-PPO loss with the value, entropy and pre-tanh terms, its gradients
by autograd, clipping by the global norm (``g * max / norm`` where the norm
is at least ``max``), and Adam (0.9, 0.999, 1e-8).
"""
from __future__ import annotations

import contextlib

import torch

from .chain import Chain
from .policy import forward, init_params, logp
from .rollouts import collect_policy

__all__ = ["precision", "train", "gae"]


@contextlib.contextmanager
def precision(tf32: bool):
    """Matmuls in TF32 (``tf32``) or in float32 for the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def gae(reward, value, gamma: float, lam: float):
    """Advantages ``[T, B]`` of one whole episode a lane."""
    adv = torch.empty_like(reward)
    g = torch.zeros_like(reward[0])
    nxt = torch.zeros_like(reward[0])
    T = reward.shape[0]
    for s in reversed(range(T)):
        live = 0.0 if s == T - 1 else 1.0
        g = reward[s] + gamma * nxt * live - value[s] + gamma * lam * live * g
        adv[s] = g
        nxt = value[s]
    return adv


def _loss(params, obs, pre, old_logp, adv, ret, ppo: dict):
    mu, log_std, value = forward(params, obs)
    lp = logp(pre, mu, log_std)
    ratio = torch.exp(lp - old_logp)
    pg = -torch.minimum(ratio * adv, torch.clamp(
        ratio, 1 - ppo["clip"], 1 + ppo["clip"]) * adv).mean()
    vf = 0.5 * ((value - ret) ** 2).mean()
    return (pg + ppo["vf_coef"] * vf + ppo["ent_coef"] * lp.mean()
            + ppo["pre_tanh_reg"] * (mu ** 2).mean())


def train(ch: Chain, cfg: dict, seed: int, B: int, iterations: int, device):
    """The first ``iterations`` of the trainer seeded ``seed``.  Returns
    ``{"loss": [the last step's loss an iteration], "grad1": [each leaf's
    first clipped gradient], "params0", "params"}`` (flat lists)."""
    ppo = cfg["ppo"]
    if ppo["minibatches"] != 1:
        raise NotImplementedError("the reference takes full-batch steps")
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, ppo["lr"]
    flat, gen = init_params(ch.obs_dim, ch.A, cfg["hidden"], seed, device)
    params0 = [p.clone() for p in flat]
    params = [p.clone().requires_grad_() for p in flat]
    m = [torch.zeros_like(p) for p in flat]
    v = [torch.zeros_like(p) for p in flat]
    losses, grad1, step = [], None, 0
    T, O, A = ch.T, ch.obs_dim, ch.A
    for _ in range(iterations):
        kseed = int(torch.randint(-2 ** 63, 2 ** 63 - 1, (),
                                  generator=gen)) % 2 ** 64
        obs, pre, old, value, rew = collect_policy(
            ch, [p.detach() for p in params], kseed, B, device)
        rew = rew * ppo["reward_scale"]
        adv = gae(rew, value, ppo["gamma"], ppo["lam"])
        ret = adv + value
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        data = (obs.permute(1, 0, 2).reshape(O, T * B),
                pre.permute(1, 0, 2).reshape(A, T * B),
                old.reshape(-1), adv.reshape(-1), ret.reshape(-1))
        del obs, pre
        for _ in range(ppo["epochs"]):
            loss = _loss(params, *data, ppo)
            grads = torch.autograd.grad(loss, params)
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            if norm >= ppo["max_grad_norm"]:
                grads = [g / norm * ppo["max_grad_norm"] for g in grads]
            if grad1 is None:
                grad1 = [g.detach().clone() for g in grads]
            step += 1
            with torch.no_grad():
                for p, g, mi, vi in zip(params, grads, m, v):
                    mi.mul_(b1).add_(g, alpha=1 - b1)
                    vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (vi.sqrt() / (1 - b2 ** step) ** 0.5).add_(eps)
                    p.addcdiv_(mi, denom, value=-lr / (1 - b1 ** step))
        losses.append(float(loss.detach()))
        del data
    return {"loss": losses, "grad1": grad1, "params0": params0,
            "params": [p.detach() for p in params]}
