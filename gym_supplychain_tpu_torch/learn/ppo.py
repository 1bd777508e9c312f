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
  above;
* ``make_beergame_ppo`` is the beer game's: categorical heads over order
  quantities (``DiscreteActorCritic``), a per-step rollout of the eager
  beer-game engine with fresh per-lane episode tables, autograd updates.

``cfg.learner_dtype = torch.bfloat16`` runs the continuous trainers'
update in bf16: the trunks under autograd, or the update kernel's bf16
mode with ``cfg.fused_update``.

A trainer returns ``(init_fn, train_step)``: ``init_fn(seed)`` builds the
state (an ``ActorCritic``, its ``torch.optim.Adam`` and a
``torch.Generator``), ``train_step(state) -> (state, metrics)`` runs one
iteration and updates the state's model and optimizer in place.  Its
phases are exposed as ``train_step.collect`` / ``.rollout``, ``.gae``,
``.prepare`` (GAE, normalization, update layout), ``.update`` and
``.loss``, so a test can feed two trainers the same tables.

``mesh=`` (``parallel/mesh.py``) runs the trainers over processes on a
``data x model`` mesh, as the JAX package's mesh forms do.  ``batch_size``
stays the global B and each rank runs the lanes ``lane_range(mesh, B)`` of
its data index, whose env streams, collection seeds and exploration noise
are the ones those lanes draw in one process (``lane0``).  Each rank
computes the loss and gradients over its lanes; one ``all_reduce`` a step
over the data group averages the loss and every gradient (packed into one
buffer), before the global-norm clip and Adam, so the norm is the global
gradient's.  Advantages are normalized by the global mean and population
std (two all-reduced passes), and the metrics are global means.  Every
rank builds the same weights and generator from the seed and makes every
draw from the generator in the same order, so the ranks stay in lockstep.

A model axis (``make_ppo``, ``make_beergame_ppo``) splits the trunks'
hidden units (``models/policy.py``: ``shard_params``, the forwards with
``mesh=``): the ranks of a model group run the same lanes with the same
draws, each on its rows of every trunk layer; the clip's norm sums the
shards' squares over the model group and adds the replicated leaves once;
``cfg.fused_update`` gathers the trunk into the whole net for the update
kernel, which each rank runs on its lanes, and keeps the rank's rows of
its gradients (JAX ``_make_update`` under a mesh).  ``make_ppo_fused``
keeps the parameters whole on every rank of a model axis, as the JAX
package's fused trainer does, with one collection kernel a data shard.
The replicated leaves stay bit-equal on every rank, the trunk rows on the
ranks of a data group.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from ..core.compile import CompiledChain
from ..envs.vector import (VecState, _split, beergame_table_config,
                           make_vec_env)
from ..models.policy import (ActorCritic, DiscreteActorCritic, MLPConfig,
                             actor_critic_forward, categorical_logp_entropy,
                             check_model_axis, discrete_forward, gather_flat,
                             shard_params, tanh_gaussian_logp, trunk_leaves)
from ..ops.ppo_update import fused_ppo_loss, make_ppo_update_grads
from ..ops.supplychain_collect import (make_supplychain_collect,
                                       philox_tables,
                                       supplychain_collect_plain)
from ..parallel.mesh import (Mesh, all_reduce_mean_, data_parallel,
                             lane_range, model_all_reduce_, tensor_parallel)
from ..utils.profiling import span

__all__ = ["PPOConfig", "TrainState", "FusedTrainState", "Trajectory",
           "make_ppo", "make_ppo_fused", "make_beergame_ppo",
           "clip_by_global_norm_"]


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
    # whole batch, so minibatches=1 is the full-batch update.  Under a mesh
    # global minibatch i is the union of every rank's i-th chunk of its own
    # lanes (the JAX mesh slices contiguous global lanes instead)
    minibatches: int = 1
    # update-phase compute dtype: None (the parameters' float32) or
    # torch.bfloat16 (the trunks in bf16 with float32 heads under autograd;
    # bf16 products with float32 accumulation in the update kernel).  The
    # rollout's forward is untouched
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
    params: ActorCritic     # DiscreteActorCritic for the beer game
    opt: torch.optim.Optimizer
    env: VecState           # env a BeerGameState for the beer game
    gen: torch.Generator    # on the trainer's device: noise, minibatches


class FusedTrainState(NamedTuple):
    params: ActorCritic
    opt: torch.optim.Optimizer
    gen: torch.Generator    # on the CPU: kernel seeds, minibatches


def _adam(params, cfg: PPOConfig):
    return torch.optim.Adam(params.parameters(), lr=cfg.lr,
                            betas=(0.9, 0.999), eps=1e-8)


def clip_by_global_norm_(params, max_norm: float, mesh: Optional[Mesh] = None,
                         shards=()) -> None:
    """optax's ``clip_by_global_norm`` on the ``.grad`` of ``params``, in
    place: every gradient becomes ``(g / norm) * max_norm`` where the global
    norm is ``>= max_norm`` (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``).  ``shards`` are the rank's rows of
    leaves split over the mesh's model axis: their squares are summed over
    the model group and the replicated ``params``' added once, so every
    rank scales by the whole tree's norm."""
    sq = [torch.sum(p.grad * p.grad) for p in shards if p.grad is not None]
    grads = [p.grad for p in (*params, *shards) if p.grad is not None]
    total = sum(torch.sum(p.grad * p.grad) for p in params
                if p.grad is not None)
    if sq:
        total = total + model_all_reduce_(mesh, torch.stack(sq).sum())
    g_norm = torch.sqrt(total)
    keep = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / g_norm) * max_norm))


def _make_gae(cfg: PPOConfig):
    """Generalized advantage estimation over a [S, B] trajectory, a reverse
    loop over S (``done`` is one flag per step: lockstep batches)."""
    def gae(traj: Trajectory, last_value):
        with span("ppo.gae"):
            S = traj.reward.shape[0]
            nonterm = torch.where(traj.done, 0.0, 1.0).to(traj.reward.dtype)
            adv = torch.empty_like(traj.reward)
            g = torch.zeros_like(last_value)
            next_value = last_value
            for s in reversed(range(S)):
                nt = nonterm[s]
                delta = (traj.reward[s] + cfg.gamma * next_value * nt
                         - traj.value[s])
                g = delta + cfg.gamma * cfg.lam * nt * g
                adv[s] = g
                next_value = traj.value[s]
            return adv, adv + traj.value

    return gae


def _make_cont_loss(cfg: PPOConfig, forward=None, mesh=None):
    """Clipped-PPO loss for the continuous tanh-Gaussian policy over
    sample-trailing arrays (``obs [obs_dim, M]``, ``pre [A, M]``, the rest
    ``[M]``; advantages already normalized).  ``params`` is an
    ``ActorCritic`` or its flat list.  ``forward(params, obs)`` defaults to
    ``actor_critic_forward`` in ``cfg.learner_dtype`` (tensor-parallel over
    a ``mesh``'s model axis)."""
    if cfg.learner_dtype not in (None, torch.bfloat16):
        raise ValueError(f"learner_dtype {cfg.learner_dtype}: None or "
                         "torch.bfloat16")
    if forward is None:
        def forward(params, obs):
            return actor_critic_forward(params, obs,
                                        compute_dtype=cfg.learner_dtype,
                                        mesh=mesh)

    def loss(params, obs, pre, old_logp, adv, ret):
        mu, log_std, value = forward(params, obs)
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


def _normalized(adv, mesh: Optional[Mesh] = None):
    """Whole-batch advantage normalization (population std, as jnp.std).
    Under a data axis the batch is every rank's: the global mean from one
    all-reduced sum, then the std from the all-reduced sum of squared
    deviations (two passes, not E[x^2] - E[x]^2)."""
    with span("ppo.normalize"):
        if not data_parallel(mesh):
            return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        mean = all_reduce_mean_(mesh, adv.mean().reshape(1))
        dev = adv - mean
        var = all_reduce_mean_(mesh, (dev * dev).mean().reshape(1))
        return dev / (torch.sqrt(var) + 1e-8)


def _flatten_traj(traj: Trajectory, adv, ret, mesh: Optional[Mesh] = None):
    """[S, X, B] trajectory -> sample-last update data ``(obs [X, S, B],
    pre [X, S, B], logp/adv/ret [S, B])`` with normalized advantages."""
    return (traj.obs.permute(1, 0, 2), traj.act_pre.permute(1, 0, 2),
            traj.logp, _normalized(adv, mesh), ret)


def _flat2(x):
    """[..., S, B] -> [..., S*B] (a view where the layout allows)."""
    return x.reshape(x.shape[:-2] + (-1,))


def _mean_grads_(mesh: Mesh, leaves, loss):
    """The loss and the ``.grad`` of every leaf (whole or the rank's rows)
    averaged over the data axis in place, packed into one buffer: one
    ``all_reduce`` over the data group (the JAX mesh's ``pmean`` over
    ``data``).  Returns the mean loss."""
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in leaves]
    buf = torch.cat([g.reshape(-1) for g in grads]
                    + [loss.detach().reshape(1).to(grads[0].dtype)])
    all_reduce_mean_(mesh, buf)
    off = 0
    for p, g in zip(leaves, grads):
        p.grad = buf[off:off + g.numel()].view_as(g)
        off += g.numel()
    return buf[-1]


def _make_update(cfg: PPOConfig, loss_fn, dims=None,
                 mesh: Optional[Mesh] = None, sharded_params: bool = False):
    """Epoch x minibatch clipped-PPO update.

    ``update(params, opt, data, generator=None) -> losses [n_steps]``: data
    is a tuple of sample-last arrays ([X, S, B] or [S, B]) flattened to
    ``[X, S*B]`` for the loss; minibatches slice the env (B) axis in an
    order drawn from ``generator`` per epoch.  ``dims = (obs_dim,
    act_dim)`` enables ``cfg.fused_update`` (the update kernel's loss and
    gradients).  Each step: gradients, ``clip_by_global_norm_``, Adam.
    With a ``mesh`` the data is the rank's lanes: each rank's loss and
    gradients over its own samples, averaged over the data axis in one
    ``all_reduce`` before the clip (``_mean_grads_``); every rank draws
    the same order from its generator.  ``sharded_params``: the trunks
    are split over the mesh's model axis (``shard_params``; ``loss_fn``
    runs the tensor-parallel forward), so the clip's norm sums the shards
    over the model group, and the update kernel runs on the whole net
    gathered once a step (``gather_flat``), each rank keeping its rows of
    the gradients.
    """
    if cfg.fused_update and dims is None:
        raise ValueError("fused_update supports the continuous-action "
                         "trainers only")
    grads_fns = {}

    def update(params, opt, data, generator=None):
        with span("ppo.update"):
            Bb = data[0].shape[-1]
            mb = int(cfg.minibatches)
            if Bb % mb != 0:
                raise ValueError(f"minibatches {mb} must divide env batch "
                                 f"{Bb}")
            bs = Bb // mb
            sz = data[0].shape[-2] * bs
            if cfg.fused_update and sz not in grads_fns:
                grads_fns[sz] = make_ppo_update_grads(
                    dims[0], dims[1], cfg.hidden, sz, clip=cfg.clip,
                    vf_coef=cfg.vf_coef, ent_coef=cfg.ent_coef,
                    pre_tanh_reg=cfg.pre_tanh_reg,
                    compute_dtype=cfg.learner_dtype)
            if generator is None or mb == 1:
                order = list(range(mb)) * cfg.epochs
            else:
                order = [i for _ in range(cfg.epochs)
                         for i in torch.randperm(
                             mb, generator=generator,
                             device=generator.device).tolist()]
            leaves = params.flat()
            shards = trunk_leaves(params) if sharded_params else []
            split = {id(p) for p in shards}
            whole = [p for p in leaves if id(p) not in split]
            losses = []
            for i in order:
                chunk = data if mb == 1 else tuple(
                    d[..., i * bs:(i + 1) * bs] for d in data)
                flat = tuple(_flat2(d) for d in chunk)
                with span("ppo.grads"):
                    if cfg.fused_update:
                        net = (gather_flat(params, mesh) if sharded_params
                               else params)
                        loss = fused_ppo_loss(grads_fns[sz], net, flat)
                    else:
                        loss, _ = loss_fn(params, *flat)
                    opt.zero_grad(set_to_none=True)
                    loss.backward()
                    if data_parallel(mesh):
                        loss = _mean_grads_(mesh, leaves, loss)
                with span("ppo.clip"):
                    clip_by_global_norm_(whole, cfg.max_grad_norm, mesh,
                                         shards)
                with span("ppo.adam"):
                    opt.step()
                losses.append(loss.detach())
            return torch.stack(losses)

    return update


def _metrics(losses, traj: Trajectory, reward_scale: float,
             mesh: Optional[Mesh] = None):
    """The last step's loss (the data axis's mean under a mesh) and the
    batch's mean reward and value (global means under a mesh: one
    all-reduce over the data group)."""
    means = all_reduce_mean_(mesh, torch.stack(
        [traj.reward.mean() / reward_scale, traj.value.mean()]))
    return {"loss": losses[-1], "mean_reward": means[0],
            "mean_value": means[1]}


def _shard(mesh: Optional[Mesh], B: int, cfg: PPOConfig, device):
    """``(device, lo, hi)``: the rank's device (the mesh's) and lanes of the
    global batch ``B`` (its data index's).  Raises where the ranks'
    minibatches would not be equal."""
    if mesh is None:
        return torch.device(device), 0, B
    if B % (mesh.data * cfg.minibatches):
        raise ValueError(f"batch {B} is not divisible by the data axis "
                         f"{mesh.data} times the minibatches "
                         f"{cfg.minibatches}")
    return (mesh.device,) + lane_range(mesh, B)


def make_ppo(cc: CompiledChain, batch_size: int, cfg: PPOConfig = PPOConfig(),
             reward_scale: float = 1e-4, device="cuda",
             mesh: Optional[Mesh] = None):
    """The scan trainer: ``cfg.rollout_steps`` steps of the batched env
    (``envs/vector.py``, auto-reset) with the policy sampled per step, then
    GAE bootstrapped from the last value and ``cfg.epochs`` PPO epochs.

    ``init_fn(seed) -> TrainState``: the weights come from a CPU generator
    seeded ``seed`` (the same weights on every device), the env streams and
    the noise generator from seeds it draws.  With a ``mesh`` the rank runs
    its lanes of the ``batch_size`` global ones on the mesh's device: the
    env at their global lane index, the noise drawn for the global ``[A,
    B]`` and cut to the rank's columns.  A model axis splits the trunks
    (the module docstring); one that does not divide ``cfg.hidden`` raises
    ``ValueError`` here.
    """
    B = batch_size
    device, lo, hi = _shard(mesh, B, cfg, device)
    tp = tensor_parallel(mesh)
    if tp:
        check_model_axis(cfg.hidden, mesh.model)
    env_init, env_step, env_obs = make_vec_env(cc, hi - lo, torch.float32,
                                               device=device, lane0=lo)
    mcfg = MLPConfig(obs_dim=cc.obs_dim, act_dim=cc.A, hidden=cfg.hidden)

    def init_fn(seed) -> TrainState:
        cpu = torch.Generator().manual_seed(int(seed))
        params = shard_params(ActorCritic(mcfg, cpu, device), mesh)
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
            mu, log_std, value = actor_critic_forward(params, obs, mesh=mesh)
            eps = torch.randn((cc.A, B), generator=gen,
                              device=device)[:, lo:hi]
            pre = mu + torch.exp(log_std) * eps
            logp = tanh_gaussian_logp(pre, mu, log_std)
            env_state, out = env_step(env_state, torch.tanh(pre))
            for k, v in (("obs", obs), ("act_pre", pre), ("logp", logp),
                         ("reward", out.reward * reward_scale),
                         ("value", value)):
                rows[k].append(v)
            rows["done"].append(out.done)
            obs = out.obs
        _, _, last_value = actor_critic_forward(params, obs, mesh=mesh)
        done = torch.tensor(rows.pop("done"), device=device)
        traj = Trajectory(done=done,
                          **{k: torch.stack(v) for k, v in rows.items()})
        return env_state, traj, last_value

    _gae = _make_gae(cfg)
    _loss = _make_cont_loss(cfg, mesh=mesh)
    _update = _make_update(cfg, _loss, dims=(cc.obs_dim, cc.A), mesh=mesh,
                           sharded_params=tp)

    def train_step(state: TrainState):
        env_state, traj, last_value = _rollout(state.params, state.env,
                                               state.gen)
        adv, ret = _gae(traj, last_value)
        losses = _update(state.params, state.opt,
                         _flatten_traj(traj, adv, ret, mesh), state.gen)
        return (state._replace(env=env_state),
                _metrics(losses, traj, reward_scale, mesh))

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
                   device="cuda", plain: bool = False,
                   mesh: Optional[Mesh] = None):
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

    With a ``mesh`` the rank collects its lanes of the ``batch_size``
    global ones on the mesh's device, at their global lane index
    (``lane0``: the kernel's Philox counters in ``prng`` mode, the tables'
    columns in ``table`` mode), so the ranks together draw the unsharded
    run's trajectories; the update data stays in the kernel's sample-major
    layout, which is per rank.  On a mesh with a model axis the parameters
    stay whole on every rank (JAX ``tests/test_ppo_fused.py``'s ``4x2``
    mesh): the ranks of a model group collect and update the same lanes.
    """
    if noise not in ("prng", "table"):
        raise ValueError(f"noise must be 'prng' or 'table', got {noise!r}")
    T, E = cc.T, episodes
    S = E * T
    device, lo, hi = _shard(mesh, batch_size, cfg, device)
    B = hi - lo                       # the rank's lanes
    O, A = cc.obs_dim, cc.A
    mcfg = MLPConfig(obs_dim=O, act_dim=A, hidden=cfg.hidden)
    mode = "policy" if noise == "prng" else "policy_eps"
    lane0 = lo if mode == "policy" else 0   # the tables carry their lanes
    if plain:
        def run(params, seed=None, **tables):
            return supplychain_collect_plain(
                cc, E, B, mode, seed=seed, params=params, sample_major=True,
                device=device, lane0=lane0, **tables)[:5]
    else:
        kernel_run = make_supplychain_collect(
            cc, T, B, mode=mode, episodes=E, device=device,
            hidden=cfg.hidden, sample_major=True, lane0=lane0)

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
                           _loss, dims=(O, A), mesh=mesh)

    def init_fn(seed) -> FusedTrainState:
        gen = torch.Generator().manual_seed(int(seed))
        params = ActorCritic(mcfg, gen, device)
        return FusedTrainState(params=params, opt=_adam(params, cfg), gen=gen)

    @torch.no_grad()
    def _collect(params, seed: int):
        """-> (obs [O, S*B], act_pre [A, S*B], logp, value, reward [S, B])."""
        with span("ppo.collect"):
            if noise == "prng":
                return run(params, seed)
            dem, lt, eps = philox_tables(cc, seed, range(S), B, device,
                                         policy=True, lane0=lo)
            return run(params, demands=dem, leadtimes=lt, eps=eps)

    @torch.no_grad()
    def _prepare(obs, pre, logp, value, rew):
        """Collected rows -> (trajectory, update data)."""
        with span("ppo.prepare"):
            traj = Trajectory(obs=obs, act_pre=pre, logp=logp,
                              reward=rew * reward_scale, value=value,
                              done=done)
            adv, ret = _gae(traj, torch.zeros_like(value[-1]))
            # free views of the [X, S*B] layout as [X, S, B]
            data = (obs.view(O, S, B), pre.view(A, S, B), logp,
                    _normalized(adv, mesh), ret)
            return traj, data

    def train_step(state: FusedTrainState):
        traj, data = _prepare(*_collect(state.params, _draw_seed(state.gen)))
        losses = _update(state.params, state.opt, data, state.gen)
        return state, _metrics(losses, traj, reward_scale, mesh)

    train_step.collect = _collect
    train_step.gae = _gae
    train_step.prepare = _prepare
    train_step.loss = _loss
    train_step.update = _update
    train_step.draw_seed = _draw_seed
    return init_fn, train_step


def make_beergame_ppo(batch_size: int, cfg: PPOConfig = PPOConfig(),
                      levels: int = 4, weeks: int = 35, max_order: int = 16,
                      customer_demand=None, shipment_delays=2,
                      initial_inventory: int = 12, v2: bool = False,
                      max_stock: int = 100,
                      exceeded_capacity_penalty: int = 100,
                      dtype=torch.float32, reward_scale: float = 1e-2,
                      device="cuda", mesh: Optional[Mesh] = None):
    """PPO for the beer game's MultiDiscrete action space: one categorical
    head per level over ``max_order`` order quantities
    (``DiscreteActorCritic``).

    The rollout steps the eager beer-game engine (``core/beergame.py``)
    ``cfg.rollout_steps`` weeks through continuous episodes; at each episode
    boundary the lanes restart on fresh tables from
    ``make_beergame_table_draw``, whose Philox key ``(seed, n)`` rides in
    ``TrainState.env.key``.  ``customer_demand`` / ``shipment_delays`` take
    the reference v2's 2-element ``randint`` ranges (per-lane tables each
    episode) or scripted values.  Actions are drawn from the state's
    generator (Gumbel-max); the update is autograd of the categorical PPO
    loss (``cfg.fused_update`` and ``cfg.learner_dtype`` are the continuous
    trainers'; they raise here).  ``init_fn(seed) -> TrainState``,
    ``train_step`` as ``make_ppo``'s.

    With a ``mesh`` (the JAX CLI shards the bare ``BeerGameState`` on its
    trailing axis) the rank runs its lanes of the ``batch_size`` global
    ones: their episode tables drawn at their global lane index
    (``lane0``), the Gumbel noise drawn for the global batch and cut to
    them; a model axis splits the discrete trunks as ``make_ppo``'s.
    """
    from ..core.beergame import make_beergame_kernels

    if cfg.learner_dtype is not None:
        raise ValueError("learner_dtype: the beer game's learner runs in "
                         "float32 (its discrete forward has no compute "
                         "dtype)")
    B, L = batch_size, levels
    device, lo, hi = _shard(mesh, B, cfg, device)
    tp = tensor_parallel(mesh)
    if tp:
        check_model_axis(cfg.hidden, mesh.model)
    tables = beergame_table_config(weeks, customer_demand, shipment_delays,
                                   device)
    weeks, draw = tables["weeks"], tables["draw"]
    reset_k, step_k, obs_k = make_beergame_kernels(
        L, weeks, tables["max_delay"], v2=v2, max_stock=max_stock,
        exceeded_capacity_penalty=exceeded_capacity_penalty,
        itype=torch.int32, device=device)
    obs_scale = 1.0 / (4.0 * tables["max_demand"])     # keep obs O(1)
    inv0 = [initial_inventory] * L
    mcfg = MLPConfig(obs_dim=L, act_dim=L, hidden=cfg.hidden)

    def _fresh(key):
        dem, dly = draw(key, hi - lo, lane0=lo)
        return reset_k(dem, dly, inv0, 4, 4, hi - lo)

    def _obs(st):
        return obs_k(st).to(dtype) * obs_scale

    def init_fn(seed) -> TrainState:
        cpu = torch.Generator().manual_seed(int(seed))
        params = shard_params(DiscreteActorCritic(mcfg, max_order, cpu,
                                                  device), mesh)
        env_seed, noise_seed = torch.randint(0, 2 ** 62, (2,),
                                             generator=cpu).tolist()
        gen = torch.Generator(device=device).manual_seed(noise_seed)
        key, sub = _split((env_seed, 0))
        return TrainState(params=params, opt=_adam(params, cfg),
                          env=VecState(key=key, env=_fresh(sub)), gen=gen)

    @torch.no_grad()
    def _rollout(params, env: VecState, gen: torch.Generator):
        key, st = env
        obs = _obs(st)
        rows = {k: [] for k in Trajectory._fields}
        for _ in range(cfg.rollout_steps):
            logits, value = discrete_forward(params, obs, L, max_order, mesh)
            u = torch.rand((L, max_order, B), generator=gen,
                           device=device)[..., lo:hi]
            act = torch.argmax(logits - torch.log(-torch.log(u)), dim=1)
            logp, _ = categorical_logp_entropy(logits, act)
            st, (_, reward, done) = step_k(st, act)
            if done:
                key, sub = _split(key)
                st = _fresh(sub)
            for k, v in (("obs", obs), ("act_pre", act), ("logp", logp),
                         ("reward", reward.to(dtype) * reward_scale),
                         ("value", value)):
                rows[k].append(v)
            rows["done"].append(done)
            obs = _obs(st)
        _, last_value = discrete_forward(params, obs, L, max_order, mesh)
        done = torch.tensor(rows.pop("done"), device=device)
        traj = Trajectory(done=done,
                          **{k: torch.stack(v) for k, v in rows.items()})
        return VecState(key=key, env=st), traj, last_value

    _gae = _make_gae(cfg)

    def _loss(params, obs, act, old_logp, adv, ret):
        logits, value = discrete_forward(params, obs, L, max_order, mesh)
        logp, ent = categorical_logp_entropy(logits, act)
        ratio = torch.exp(logp - old_logp)
        pg = -torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - cfg.clip, 1 + cfg.clip) * adv).mean()
        vf = 0.5 * ((value - ret) ** 2).mean()
        return pg + cfg.vf_coef * vf - cfg.ent_coef * ent.mean(), (pg, vf)

    _update = _make_update(cfg, _loss, mesh=mesh, sharded_params=tp)

    def train_step(state: TrainState):
        env, traj, last_value = _rollout(state.params, state.env, state.gen)
        adv, ret = _gae(traj, last_value)
        losses = _update(state.params, state.opt,
                         _flatten_traj(traj, adv, ret, mesh), state.gen)
        return (state._replace(env=env),
                _metrics(losses, traj, reward_scale, mesh))

    train_step.rollout = _rollout
    train_step.gae = _gae
    train_step.loss = _loss
    train_step.update = _update
    return init_fn, train_step

