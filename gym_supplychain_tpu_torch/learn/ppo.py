"""PPO for the continuous-action supply-chain envs, on PyTorch.

The counterpart of ``gym_supplychain_tpu/learn/ppo.py``: GAE and clipped-PPO
epochs over whole batches of lockstep envs, with the same configuration,
loss, advantage normalization and optimizer (gradient clipping by global
norm, then Adam with b1 0.9, b2 0.999, eps 1e-8, as optax does).

* ``make_ppo_fused`` collects whole episodes through the collect kernel's
  policy modes (``ops/supplychain_collect.py``) in the update's sample
  layout, and with ``cfg.fused_update`` computes the update's loss and
  gradients with the PPO update kernel (``ops/ppo_update.py``);
* ``make_ppo`` is the scan trainer: a per-step rollout over the batched env
  of ``envs/vector.py`` with plain PyTorch ops, ``cfg.fused_update`` as
  above.

A trainer returns ``(init_fn, train_step)``: ``init_fn(seed)`` builds the
state (an ``ActorCritic``, its ``torch.optim.Adam`` and a
``torch.Generator``), ``train_step(state) -> (state, metrics)`` runs one
iteration and updates the state's model and optimizer in place.  Its
phases are exposed as ``train_step.collect`` / ``.rollout``, ``.gae``,
``.prepare`` (GAE, normalization, update layout), ``.update`` and
``.loss``, so a test can feed two trainers the same tables.

Not ported yet: the beer game's discrete trainer (``make_beergame_ppo``),
the bf16 learner (``learner_dtype``) and the mesh forms of both trainers.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from ..core.compile import CompiledChain
from ..envs.vector import VecState, make_vec_env
from ..models.policy import (ActorCritic, MLPConfig, actor_critic_forward,
                             flat_params, tanh_gaussian_logp)
from ..ops.ppo_update import fused_ppo_loss, make_ppo_update_grads
from ..ops.supplychain_collect import (make_supplychain_collect,
                                       philox_tables,
                                       supplychain_collect_plain)

__all__ = ["PPOConfig", "TrainState", "FusedTrainState", "Trajectory",
           "make_ppo", "make_ppo_fused", "clip_by_global_norm_"]


class PPOConfig(NamedTuple):
    """The JAX package's ``PPOConfig`` (its scan-unroll and interpret-mode
    knobs have no counterpart here)."""
    rollout_steps: int = 16
    epochs: int = 4
    gamma: float = 0.99
    lam: float = 0.95
    clip: float = 0.2
    lr: float = 1e-3
    ent_coef: float = 1e-3
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    # L2 penalty on pre-tanh action means: keeps the squashed policy off the
    # tanh saturation rails where gradients vanish
    pre_tanh_reg: float = 1e-3
    hidden: Tuple[int, ...] = (128, 128)
    # minibatches per epoch (one optimizer step each); chunks slice the env
    # axis in a fresh order per epoch; advantages are normalized over the
    # whole batch, so minibatches=1 is the full-batch update
    minibatches: int = 1
    # update-phase trunk dtype; only None (the parameters' float32) is
    # ported
    learner_dtype: Any = None
    # the update's forward + loss + backward as one CUDA kernel
    # (ops/ppo_update.py); continuous-action trainers only
    fused_update: bool = False


class Trajectory(NamedTuple):
    obs: torch.Tensor       # [S, obs_dim, B], or [obs_dim, S*B] (fused)
    act_pre: torch.Tensor   # [S, A, B] pre-tanh actions, or [A, S*B]
    logp: torch.Tensor      # [S, B]
    reward: torch.Tensor    # [S, B]
    value: torch.Tensor     # [S, B]
    done: torch.Tensor      # [S] bool


class TrainState(NamedTuple):
    params: ActorCritic
    opt: torch.optim.Optimizer
    env: VecState
    gen: torch.Generator    # on the trainer's device: noise, minibatches


class FusedTrainState(NamedTuple):
    params: ActorCritic
    opt: torch.optim.Optimizer
    gen: torch.Generator    # on the CPU: kernel seeds, minibatches


def _adam(params: ActorCritic, cfg: PPOConfig):
    return torch.optim.Adam(params.parameters(), lr=cfg.lr,
                            betas=(0.9, 0.999), eps=1e-8)


def clip_by_global_norm_(params, max_norm: float) -> None:
    """optax's ``clip_by_global_norm`` on the ``.grad`` of ``params``, in
    place: every gradient becomes ``(g / norm) * max_norm`` where the global
    norm is ``>= max_norm`` (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``)."""
    grads = [p.grad for p in params if p.grad is not None]
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / g_norm) * max_norm))


def _make_gae(cfg: PPOConfig):
    """Generalized advantage estimation over a [S, B] trajectory, a reverse
    loop over S (``done`` is one flag per step: lockstep batches)."""
    def gae(traj: Trajectory, last_value):
        S = traj.reward.shape[0]
        nonterm = torch.where(traj.done, 0.0, 1.0).to(traj.reward.dtype)
        adv = torch.empty_like(traj.reward)
        g = torch.zeros_like(last_value)
        next_value = last_value
        for s in reversed(range(S)):
            nt = nonterm[s]
            delta = traj.reward[s] + cfg.gamma * next_value * nt - traj.value[s]
            g = delta + cfg.gamma * cfg.lam * nt * g
            adv[s] = g
            next_value = traj.value[s]
        return adv, adv + traj.value

    return gae


def _make_cont_loss(cfg: PPOConfig):
    """Clipped-PPO loss for the continuous tanh-Gaussian policy over
    sample-trailing arrays (``obs [obs_dim, M]``, ``pre [A, M]``, the rest
    ``[M]``; advantages already normalized).  ``params`` is an
    ``ActorCritic`` or its flat list."""
    if cfg.learner_dtype is not None:
        raise NotImplementedError("learner_dtype: only the float32 learner "
                                  "is ported")

    def loss(params, obs, pre, old_logp, adv, ret):
        mu, log_std, value = actor_critic_forward(params, obs)
        logp = tanh_gaussian_logp(pre, mu, log_std)
        ratio = torch.exp(logp - old_logp)
        pg = -torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - cfg.clip, 1 + cfg.clip) * adv).mean()
        vf = 0.5 * ((value - ret) ** 2).mean()
        # entropy of the squashed policy estimated as -E[log pi(a|s)]
        ent = -logp.mean()
        reg = (mu ** 2).mean()
        return (pg + cfg.vf_coef * vf - cfg.ent_coef * ent
                + cfg.pre_tanh_reg * reg), (pg, vf)

    return loss


def _normalized(adv):
    """Whole-batch advantage normalization (population std, as jnp.std)."""
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


def _flatten_traj(traj: Trajectory, adv, ret):
    """[S, X, B] trajectory -> sample-last update data ``(obs [X, S, B],
    pre [X, S, B], logp/adv/ret [S, B])`` with normalized advantages."""
    return (traj.obs.permute(1, 0, 2), traj.act_pre.permute(1, 0, 2),
            traj.logp, _normalized(adv), ret)


def _flat2(x):
    """[..., S, B] -> [..., S*B] (a view where the layout allows)."""
    return x.reshape(x.shape[:-2] + (-1,))


def _make_update(cfg: PPOConfig, loss_fn, dims=None):
    """Epoch x minibatch clipped-PPO update.

    ``update(params, opt, data, generator=None) -> losses [n_steps]``: data
    is a tuple of sample-last arrays ([X, S, B] or [S, B]) flattened to
    ``[X, S*B]`` for the loss; minibatches slice the env (B) axis in an
    order drawn from ``generator`` per epoch.  ``dims = (obs_dim,
    act_dim)`` enables ``cfg.fused_update`` (the update kernel's loss and
    gradients).  Each step: gradients, ``clip_by_global_norm_``, Adam.
    """
    if cfg.fused_update and dims is None:
        raise ValueError("fused_update supports the continuous-action "
                         "trainers only")
    grads_fns = {}

    def update(params, opt, data, generator=None):
        Bb = data[0].shape[-1]
        mb = int(cfg.minibatches)
        if Bb % mb != 0:
            raise ValueError(f"minibatches {mb} must divide env batch {Bb}")
        bs = Bb // mb
        sz = data[0].shape[-2] * bs
        if cfg.fused_update and sz not in grads_fns:
            grads_fns[sz] = make_ppo_update_grads(
                dims[0], dims[1], cfg.hidden, sz, clip=cfg.clip,
                vf_coef=cfg.vf_coef, ent_coef=cfg.ent_coef,
                pre_tanh_reg=cfg.pre_tanh_reg)
        if generator is None or mb == 1:
            order = list(range(mb)) * cfg.epochs
        else:
            order = [i for _ in range(cfg.epochs)
                     for i in torch.randperm(mb, generator=generator,
                                             device=generator.device).tolist()]
        leaves = flat_params(params)
        losses = []
        for i in order:
            chunk = data if mb == 1 else tuple(
                d[..., i * bs:(i + 1) * bs] for d in data)
            flat = tuple(_flat2(d) for d in chunk)
            if cfg.fused_update:
                loss = fused_ppo_loss(grads_fns[sz], params, flat)
            else:
                loss, _ = loss_fn(params, *flat)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            clip_by_global_norm_(leaves, cfg.max_grad_norm)
            opt.step()
            losses.append(loss.detach())
        return torch.stack(losses)

    return update


def _metrics(losses, traj: Trajectory, reward_scale: float):
    return {"loss": losses[-1],
            "mean_reward": traj.reward.mean() / reward_scale,
            "mean_value": traj.value.mean()}


def make_ppo(cc: CompiledChain, batch_size: int, cfg: PPOConfig = PPOConfig(),
             reward_scale: float = 1e-4, device="cpu"):
    """The scan trainer: ``cfg.rollout_steps`` steps of the batched env
    (``envs/vector.py``, auto-reset) with the policy sampled per step, then
    GAE bootstrapped from the last value and ``cfg.epochs`` PPO epochs.

    ``init_fn(seed) -> TrainState``: the weights come from a CPU generator
    seeded ``seed`` (the same weights on every device), the env streams and
    the noise generator from seeds it draws.
    """
    device = torch.device(device)
    B = batch_size
    env_init, env_step, env_obs = make_vec_env(cc, B, torch.float32,
                                               device=device)
    mcfg = MLPConfig(obs_dim=cc.obs_dim, act_dim=cc.A, hidden=cfg.hidden)

    def init_fn(seed) -> TrainState:
        cpu = torch.Generator().manual_seed(int(seed))
        params = ActorCritic(mcfg, cpu, device)
        env_seed, noise_seed = torch.randint(0, 2 ** 62, (2,),
                                             generator=cpu).tolist()
        gen = torch.Generator(device=device).manual_seed(noise_seed)
        return TrainState(params=params, opt=_adam(params, cfg),
                          env=env_init(env_seed), gen=gen)

    @torch.no_grad()
    def _rollout(params, env_state: VecState, gen: torch.Generator):
        obs = env_obs(env_state)
        rows = {k: [] for k in Trajectory._fields}
        for _ in range(cfg.rollout_steps):
            mu, log_std, value = actor_critic_forward(params, obs)
            eps = torch.randn(mu.shape, generator=gen, device=device)
            pre = mu + torch.exp(log_std) * eps
            logp = tanh_gaussian_logp(pre, mu, log_std)
            env_state, out = env_step(env_state, torch.tanh(pre))
            for k, v in (("obs", obs), ("act_pre", pre), ("logp", logp),
                         ("reward", out.reward * reward_scale),
                         ("value", value)):
                rows[k].append(v)
            rows["done"].append(out.done)
            obs = out.obs
        _, _, last_value = actor_critic_forward(params, obs)
        done = torch.tensor(rows.pop("done"), device=device)
        traj = Trajectory(done=done,
                          **{k: torch.stack(v) for k, v in rows.items()})
        return env_state, traj, last_value

    _gae = _make_gae(cfg)
    _loss = _make_cont_loss(cfg)
    _update = _make_update(cfg, _loss, dims=(cc.obs_dim, cc.A))

    def train_step(state: TrainState):
        env_state, traj, last_value = _rollout(state.params, state.env,
                                               state.gen)
        adv, ret = _gae(traj, last_value)
        losses = _update(state.params, state.opt,
                         _flatten_traj(traj, adv, ret), state.gen)
        return (state._replace(env=env_state),
                _metrics(losses, traj, reward_scale))

    train_step.rollout = _rollout
    train_step.gae = _gae
    train_step.loss = _loss
    train_step.update = _update
    return init_fn, train_step


def _draw_seed(gen: torch.Generator) -> int:
    """A 64-bit kernel seed from the trainer's generator."""
    x = int(torch.randint(-2 ** 63, 2 ** 63 - 1, (), generator=gen))
    return x % 2 ** 64


def make_ppo_fused(cc: CompiledChain, batch_size: int,
                   cfg: PPOConfig = PPOConfig(), episodes: int = 1,
                   noise: str = "prng", reward_scale: float = 1e-4,
                   device="cpu", plain: bool = False):
    """PPO with whole-episode collection through the collect kernel.

    Each iteration collects ``episodes`` back-to-back ``cc.T``-step
    episodes for every env in one launch (in-kernel auto-reset), emitting
    obs and pre-tanh actions in the update's ``[X, S*B]`` layout, then runs
    GAE (no bootstrap: episodes are whole) and the PPO epochs.

    ``noise='prng'`` runs the kernel's ``policy`` mode, which draws the
    demand, lead-time and noise rows in-kernel from Philox under the
    iteration's seed (a 64-bit draw from the state's generator);
    ``noise='table'`` draws the same rows as tables
    (``philox_tables(..., policy=True)``) and runs ``policy_eps``, so both
    give the same trajectories for a seed.  ``plain=True`` runs the plain
    PyTorch versions of both kernels on ``device`` (plain collection and
    autograd of the loss): the baseline the kernels are timed and held
    against.  On the CPU the kernels' wrappers run their plain versions
    anyway.
    """
    if noise not in ("prng", "table"):
        raise ValueError(f"noise must be 'prng' or 'table', got {noise!r}")
    device = torch.device(device)
    B, T, E = batch_size, cc.T, episodes
    S = E * T
    O, A = cc.obs_dim, cc.A
    mcfg = MLPConfig(obs_dim=O, act_dim=A, hidden=cfg.hidden)
    mode = "policy" if noise == "prng" else "policy_eps"
    if plain:
        def run(params, seed=None, **tables):
            return supplychain_collect_plain(
                cc, E, B, mode, seed=seed, params=params, sample_major=True,
                device=device, **tables)[:5]
    else:
        kernel_run = make_supplychain_collect(
            cc, T, B, mode=mode, episodes=E, device=device,
            hidden=cfg.hidden, sample_major=True)

        def run(params, seed=None, **tables):
            if mode == "policy":
                return kernel_run(params, seed)
            rows = [tables["demands"]] + (
                [tables["leadtimes"]] if cc.stochastic_leadtimes else [])
            return kernel_run(*rows, tables["eps"], params)
    # one whole episode per lane per iteration => terminal at step T-1
    done = (torch.arange(S, device=device) % T) == T - 1
    _gae = _make_gae(cfg)
    _loss = _make_cont_loss(cfg)
    _update = _make_update(cfg._replace(fused_update=False) if plain else cfg,
                           _loss, dims=(O, A))

    def init_fn(seed) -> FusedTrainState:
        gen = torch.Generator().manual_seed(int(seed))
        params = ActorCritic(mcfg, gen, device)
        return FusedTrainState(params=params, opt=_adam(params, cfg), gen=gen)

    @torch.no_grad()
    def _collect(params, seed: int):
        """-> (obs [O, S*B], act_pre [A, S*B], logp, value, reward [S, B])."""
        if noise == "prng":
            return run(params, seed)
        dem, lt, eps = philox_tables(cc, seed, range(S), B, device,
                                     policy=True)
        return run(params, demands=dem, leadtimes=lt, eps=eps)

    @torch.no_grad()
    def _prepare(obs, pre, logp, value, rew):
        """Collected rows -> (trajectory, update data)."""
        traj = Trajectory(obs=obs, act_pre=pre, logp=logp,
                          reward=rew * reward_scale, value=value, done=done)
        adv, ret = _gae(traj, torch.zeros_like(value[-1]))
        # free views of the [X, S*B] layout as [X, S, B]
        data = (obs.view(O, S, B), pre.view(A, S, B), logp, _normalized(adv),
                ret)
        return traj, data

    def train_step(state: FusedTrainState):
        traj, data = _prepare(*_collect(state.params, _draw_seed(state.gen)))
        losses = _update(state.params, state.opt, data, state.gen)
        return state, _metrics(losses, traj, reward_scale)

    train_step.collect = _collect
    train_step.gae = _gae
    train_step.prepare = _prepare
    train_step.loss = _loss
    train_step.update = _update
    train_step.draw_seed = _draw_seed
    return init_fn, train_step
