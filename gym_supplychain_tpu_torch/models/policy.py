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

``DiscreteActorCritic`` is the beer game's MultiDiscrete counterpart
(``init_discrete_actor_critic``): the same trunks with a ``logits`` head of
``act_dim * n_choices`` rows in place of ``mu`` and ``log_std``.

Tensor parallelism over the mesh's model axis (``param_shardings``'
counterpart): ``shard_params`` keeps rows ``[m*h/M, (m+1)*h/M)`` of every
trunk layer's ``w`` and ``b`` on model rank ``m`` of ``M`` (the heads and
``log_std`` stay whole), and ``gather_params`` / ``gather_flat`` turn the
shards back into the whole net.  With a ``mesh`` the forwards compute each
trunk layer on the local rows, ``tanh``, and gather the actor's and the
critic's activations over the model group in one collective
(``_GatherRows``).  Every rank of a model group computes the same loss, so
the gradient a rank's autograd sees for a gathered activation is its own
rows' use of it: where the next trunk layer's local rows consume it, the
gradient is the sum over the group (a reduce-scatter); where the
replicated heads consume it, every rank already holds the whole gradient
and keeps its rows.
"""
from __future__ import annotations

import copy
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from ..parallel.mesh import (gather_rows, local_rows, reduce_scatter_rows,
                             tensor_parallel)

__all__ = ["MLPConfig", "ActorCritic", "actor_critic_forward",
           "DiscreteActorCritic", "discrete_forward",
           "categorical_logp_entropy", "tanh_gaussian_logp",
           "tanh_gaussian_terms", "sample_tanh_gaussian", "softplus",
           "flat_params", "split_params", "params_from_jax",
           "discrete_params_from_jax", "params_to_numpy", "shard_params",
           "gather_params", "gather_flat", "trunk_leaves",
           "check_model_axis", "LOG_STD_MIN", "LOG_STD_MAX"]

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
        self.actor, n_in = _trunk(cfg.obs_dim, self.cfg.hidden)
        self.mu = Dense(cfg.act_dim, n_in)
        self.critic, _ = _trunk(cfg.obs_dim, self.cfg.hidden)
        self.v = Dense(1, n_in)
        self.log_std = nn.Parameter(torch.full((cfg.act_dim, 1), -0.5))
        _init_dense(self._init_order(), generator)
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


def _trunk(n_in: int, hidden):
    """Dense layers of widths ``hidden`` from ``n_in`` inputs -> (layers,
    the last width)."""
    layers = nn.ModuleList()
    for h in hidden:
        layers.append(Dense(h, n_in))
        n_in = h
    return layers, n_in


def _init_dense(order, generator):
    """``w ~ N(0, 1) * scale / sqrt(n_in)`` for each ``(layer, scale)``, in
    order, from ``generator`` on the CPU."""
    with torch.no_grad():
        for layer, scale in order:
            n_out, n_in = layer.w.shape
            w = torch.randn((n_out, n_in), generator=generator)
            layer.w.copy_(w * scale / math.sqrt(n_in))


class DiscreteActorCritic(nn.Module):
    """Actor-critic for a MultiDiscrete action space (the beer game's order
    quantities): ``cfg.act_dim`` independent categoricals of ``n_choices``
    options each from a ``logits`` head ``[act_dim * n_choices, n_in]`` on
    the actor trunk, and the ``v`` head on the critic trunk.  The trunks may
    be empty (``hidden=()``: the heads read the obs).

    Initialised as ``init_discrete_actor_critic`` does: the trunks and ``v``
    as ``ActorCritic``'s, ``logits.w ~ N(0, 1) * 0.01 / sqrt(n_in)``, zero
    biases, from ``generator`` on the CPU.  ``flat()`` orders the
    parameters actor trunk, ``logits``, critic trunk, ``v``.
    """

    def __init__(self, cfg: MLPConfig, n_choices: int,
                 generator: torch.Generator = None, device="cuda"):
        super().__init__()
        self.cfg = MLPConfig(cfg.obs_dim, cfg.act_dim, tuple(cfg.hidden))
        self.n_choices = int(n_choices)
        self.actor, n_in = _trunk(cfg.obs_dim, self.cfg.hidden)
        self.logits = Dense(cfg.act_dim * self.n_choices, n_in)
        self.critic, _ = _trunk(cfg.obs_dim, self.cfg.hidden)
        self.v = Dense(1, n_in)
        order = [(layer, 1.0) for pair in zip(self.actor, self.critic)
                 for layer in pair]
        _init_dense(order + [(self.v, 1.0), (self.logits, 0.01)], generator)
        self.to(device)

    def flat(self):
        flat = []
        for layer in (*self.actor, self.logits, *self.critic, self.v):
            flat += [layer.w, layer.b]
        return flat

    def forward(self, obs):
        return discrete_forward(self, obs, self.cfg.act_dim, self.n_choices)


def discrete_forward(params: DiscreteActorCritic, obs, act_dim: int,
                     n_choices: int, mesh=None):
    """obs [obs_dim, B] -> (logits [act_dim, n_choices, B], value [B]).
    With a ``mesh`` whose model axis splits the trunks (``shard_params``),
    each layer runs on the rank's rows and its activations are gathered."""
    a, c = _trunks([(layer.w, layer.b) for layer in params.actor],
                   [(layer.w, layer.b) for layer in params.critic], obs,
                   _tanh_layer, mesh)
    logits = params.logits.w @ a + params.logits.b
    v = (params.v.w @ c + params.v.b)[0]
    return logits.reshape(act_dim, n_choices, -1), v


def categorical_logp_entropy(logits, act):
    """logits [A, n, B], act [A, B] int -> (logp [B], entropy [B]): the
    log-probability summed over the independent action dims, and the sum of
    their exact categorical entropies."""
    logp_all = torch.log_softmax(logits, dim=1)
    logp_act = torch.gather(logp_all, 1, act.long()[:, None, :])[:, 0]
    ent = -(torch.exp(logp_all) * logp_all).sum(dim=1)
    return logp_act.sum(dim=0), ent.sum(dim=0)


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


def actor_critic_forward(params, obs, compute_dtype=None, mesh=None):
    """obs [obs_dim, B] -> (mu [A, B], log_std [A, 1], value [B]).

    ``params`` is an ``ActorCritic`` or its flat list.  ``compute_dtype``
    (``torch.bfloat16``) runs the trunks' products and biases in that dtype
    and rounds forward and backward where the JAX package's jitted XLA:CPU
    graph of its XLA path rounds (``_LowPrecisionTanhLayer``); the ``mu``
    and ``v`` heads and ``log_std`` stay in the parameters' dtype, as that
    path keeps them (the update kernel's bf16 mode rounds the heads'
    operands too: ``ops/ppo_update.py``).  ``None`` uses every tensor in its
    own dtype (the rollout path).  With a ``mesh`` whose model axis splits
    the trunks (``shard_params``), each layer runs on the rank's rows and
    its activations, in the dtype the layer emits, are gathered."""
    actor, mu_l, critic, v_l, log_std = split_params(params)
    if compute_dtype is None:
        a, c = _trunks(actor, critic, obs, _tanh_layer, mesh)
    else:
        # as the JAX package's jitted XLA:CPU graph runs a trunk: each
        # layer's input rounded to the dtype, the last layer's float32 tanh
        # handed to the head unrounded (XLA drops that rounding)
        def layer(x, w, b):
            return _LowPrecisionTanhLayer.apply(x.to(compute_dtype), w, b)

        a, c = _trunks(actor, critic, obs.to(compute_dtype), layer, mesh)
    mu = mu_l[0] @ a.to(mu_l[0].dtype) + mu_l[1]
    v = (v_l[0] @ c.to(v_l[0].dtype) + v_l[1])[0]
    return mu, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX), v


def _tanh_layer(x, w, b):
    return torch.tanh(w @ x + b)


def _trunks(actor, critic, obs, layer, mesh=None):
    """The actor's and the critic's trunks ``[(w, b)]`` over ``obs``, layer
    by layer (``layer(x, w, b)``); under a model axis each layer's two
    activations are gathered in one collective, the last for the heads."""
    a = c = obs
    for i, ((wa, ba), (wc, bc)) in enumerate(zip(actor, critic,
                                                 strict=True)):
        a, c = layer(a, wa, ba), layer(c, wc, bc)
        if tensor_parallel(mesh):
            a, c = _GatherRows.apply(
                mesh, "sharded" if i + 1 < len(actor) else "replicated", a, c)
    return a, c


class _GatherRows(torch.autograd.Function):
    """``_GatherRows.apply(mesh, consumer, *xs)``: each ``x [r, ...]``
    gathered over the model group into ``[M * r, ...]`` (one collective).

    Every rank of the group computes the same loss, so the gradient a
    rank's autograd hands back is its consumer's use of the gathered
    tensor.  ``consumer`` says whose use that is: ``"sharded"``, the next
    trunk layer's local rows, each rank holding one part of the whole
    gradient: the backward sums the parts over the group and keeps the
    rank's rows (a reduce-scatter); ``"replicated"``, the heads or the
    whole-net update kernel, which every rank runs whole: each rank already
    holds the whole gradient and keeps its rows (summing would count it
    ``M`` times)."""

    @staticmethod
    def forward(ctx, mesh, consumer, *xs):
        if consumer not in ("sharded", "replicated"):
            raise ValueError(f"consumer {consumer!r}: 'sharded' or "
                             "'replicated'")
        ctx.mesh, ctx.consumer = mesh, consumer
        return tuple(gather_rows(mesh, xs))

    @staticmethod
    def backward(ctx, *gs):
        if ctx.consumer == "sharded":
            local = reduce_scatter_rows(ctx.mesh, gs)
        else:
            local = [local_rows(ctx.mesh, g) for g in gs]
        return (None, None, *local)


def check_model_axis(hidden, model: int) -> None:
    """Raise ``ValueError`` where the model axis does not divide every
    hidden width (each rank holds ``h / model`` rows of a layer)."""
    bad = [h for h in hidden if h % model]
    if model > 1 and bad:
        raise ValueError(f"hidden widths {tuple(hidden)}: {bad} not "
                         f"divisible by the model axis {model}")


def _trunk_layers(params):
    return (*params.actor, *params.critic)


def trunk_leaves(params):
    """The trunk layers' ``w`` and ``b`` (the leaves a model axis splits),
    actor then critic."""
    return [p for layer in _trunk_layers(params) for p in (layer.w, layer.b)]


def shard_params(params, mesh):
    """``params`` (an ``ActorCritic`` or ``DiscreteActorCritic`` built
    whole, the same on every rank) cut in place to the rank's rows of every
    trunk layer: ``param_shardings``' ``P("model", None)`` on the trunks,
    the heads and ``log_std`` whole.  Build the optimizer after.  A no-op
    without a model axis; raises ``ValueError`` where it does not divide
    the widths."""
    if not tensor_parallel(mesh):
        return params
    check_model_axis(params.cfg.hidden, mesh.model)
    with torch.no_grad():
        for layer in _trunk_layers(params):
            layer.w = nn.Parameter(local_rows(mesh, layer.w).clone())
            layer.b = nn.Parameter(local_rows(mesh, layer.b).clone())
    return params


def gather_params(params, mesh):
    """The whole net of a sharded ``params`` (a new module on the same
    device, detached; every trunk gathered in one collective); ``params``
    itself without a model axis."""
    if not tensor_parallel(mesh):
        return params
    whole = copy.deepcopy(params)
    leaves = trunk_leaves(params)
    full = gather_rows(mesh, [p.detach() for p in leaves])
    with torch.no_grad():
        for layer, w, b in zip(_trunk_layers(whole), full[0::2], full[1::2]):
            layer.w = nn.Parameter(w.clone())
            layer.b = nn.Parameter(b.clone())
    return whole


def gather_flat(params, mesh):
    """``params.flat()`` of the whole net, differentiable with respect to
    the rank's shards: the trunks gathered in one collective for a consumer
    that every rank runs whole (the update kernel), so the backward keeps
    each rank's rows of the whole gradient.  ``params.flat()`` without a
    model axis."""
    flat = params.flat()
    if not tensor_parallel(mesh):
        return flat
    ids = {id(p) for p in trunk_leaves(params)}
    idx = [i for i, p in enumerate(flat) if id(p) in ids]
    full = _GatherRows.apply(mesh, "replicated", *(flat[i] for i in idx))
    for i, x in zip(idx, full):
        flat[i] = x
    return flat


_XLA_WINDOW = 32


def _xla_cpu_row_sum(x: torch.Tensor) -> torch.Tensor:
    """``x [R, n]`` summed over its rows in ``x``'s dtype the way XLA:CPU
    sums a bf16 reduction: while a row is longer than 32, windows of 32
    (the row zero-padded at both ends, the lower pad the smaller) are
    summed in order, each add rounded to the dtype; then the last row of at
    most 32 the same way."""
    while x.shape[1] > _XLA_WINDOW:
        n = x.shape[1]
        windows = -(-n // _XLA_WINDOW)
        pad = windows * _XLA_WINDOW - n
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = x.view(x.shape[0], windows, _XLA_WINDOW)
        acc = x[..., 0]
        for j in range(1, _XLA_WINDOW):
            acc = acc + x[..., j]
        x = acc
    acc = x[:, 0]
    for j in range(1, x.shape[1]):
        acc = acc + x[:, j]
    return acc


class _LowPrecisionTanhLayer(torch.autograd.Function):
    """``tanh(w @ x + b)`` for ``x`` in a low precision (bf16), rounded
    where the JAX package's jitted XLA:CPU graph rounds: forward, the
    product and the bias add in ``x``'s dtype, ``tanh`` in float32 (its
    output unrounded); backward, the incoming gradient rounded to the
    dtype, tanh's derivative as ``dq = g * (1 - y)``, ``dq + dq * y`` with
    each op rounded, the bias gradient summed by ``_xla_cpu_row_sum``, the
    input gradient rounded once, the weight gradient left in float32."""

    @staticmethod
    def forward(ctx, x, w, b):
        wl = w.to(x.dtype)
        y = torch.tanh((wl @ x + b.to(x.dtype)).float())
        ctx.save_for_backward(x, wl, y.to(x.dtype))
        ctx.dtypes = (w.dtype, b.dtype)
        return y

    @staticmethod
    def backward(ctx, g):
        x, wl, y = ctx.saved_tensors
        dq = g.to(y.dtype) * (1 - y)
        ds = dq + dq * y
        db = _xla_cpu_row_sum(ds)[:, None]
        return (wl.t() @ ds, (ds.float() @ x.float().t()).to(ctx.dtypes[0]),
                db.to(ctx.dtypes[1]))


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


def _pairs(layers):
    return [x for layer in layers for x in (layer["w"], layer["b"])]


def _load(model, src):
    """Copy the arrays ``src`` into ``model.flat()``, shape for shape."""
    with torch.no_grad():
        for p, x in zip(model.flat(), src, strict=True):
            x = np.array(x, np.float32)
            if x.shape != tuple(p.shape):
                raise ValueError(f"shape {x.shape}, expected {tuple(p.shape)}")
            p.copy_(torch.from_numpy(x))
    return model


def params_from_jax(tree, device="cuda") -> ActorCritic:
    """An ``ActorCritic`` holding the values of an ``init_actor_critic``
    tree (numpy or JAX arrays: ``{"actor": [{"w", "b"}], "critic": [...],
    "mu", "v", "log_std"}``)."""
    hidden = tuple(int(np.shape(layer["w"])[0]) for layer in tree["actor"])
    obs_dim = int(np.shape(tree["actor"][0]["w"])[1])
    act_dim = int(np.shape(tree["mu"]["w"])[0])
    model = ActorCritic(MLPConfig(obs_dim, act_dim, hidden), device="cpu")
    src = (_pairs(tree["actor"]) + _pairs([tree["mu"]])
           + _pairs(tree["critic"]) + _pairs([tree["v"]]) + [tree["log_std"]])
    return _load(model, src).to(device)


def discrete_params_from_jax(tree, n_choices: int,
                             device="cuda") -> DiscreteActorCritic:
    """A ``DiscreteActorCritic`` holding the values of an
    ``init_discrete_actor_critic`` tree (``"logits"`` in place of ``"mu"``
    and ``"log_std"``) of ``n_choices`` options an action dim."""
    hidden = tuple(int(np.shape(layer["w"])[0]) for layer in tree["actor"])
    rows, n_in = np.shape(tree["logits"]["w"])
    obs_dim = int(np.shape(tree["actor"][0]["w"])[1]) if hidden else n_in
    if rows % n_choices:
        raise ValueError(f"{rows} logits rows is no multiple of "
                         f"{n_choices} choices")
    model = DiscreteActorCritic(
        MLPConfig(obs_dim, rows // n_choices, hidden), n_choices,
        device="cpu")
    src = (_pairs(tree["actor"]) + _pairs([tree["logits"]])
           + _pairs(tree["critic"]) + _pairs([tree["v"]]))
    return _load(model, src).to(device)


def params_to_numpy(params) -> dict:
    """The JAX package's parameter tree of an ``ActorCritic`` (or its flat
    list) or a ``DiscreteActorCritic``, as float32 numpy arrays (copies,
    not views of the parameters)."""
    def n(x):
        return x.detach().cpu().numpy().copy()

    def dense(layer):
        return {"w": n(layer.w), "b": n(layer.b)}

    if isinstance(params, DiscreteActorCritic):
        return {"actor": [dense(layer) for layer in params.actor],
                "critic": [dense(layer) for layer in params.critic],
                "logits": dense(params.logits), "v": dense(params.v)}
    actor, mu_l, critic, v_l, log_std = split_params(params)
    return {"actor": [{"w": n(w), "b": n(b)} for w, b in actor],
            "critic": [{"w": n(w), "b": n(b)} for w, b in critic],
            "mu": {"w": n(mu_l[0]), "b": n(mu_l[1])},
            "v": {"w": n(v_l[0]), "b": n(v_l[1])},
            "log_std": n(log_std)}
