"""Checkpoint and exact resume of a training run, in one process or many.

The counterpart of ``gym_supplychain_tpu/utils/checkpoint.py``.  A
checkpoint is one file, ``<dir>/step_<N>.pt``, written with ``torch.save``
and read with ``torch.load(..., weights_only=True)``, so it holds tensors
and plain containers only:

    {"format": "gst-torch-ckpt-v1", "step": N, "kind": "TrainState" or
     "FusedTrainState", "mlp": {"obs_dim", "act_dim", "hidden"} and, for
     the beer game's ``DiscreteActorCritic``, "n_choices",
     "params": the actor-critic's state dict, "opt": Adam's state dict,
     "gen": {"device", "state"}, "env": the scan trainer's ``VecState`` as
     a dict, its env an ``EnvState`` or the beer game's ``BeerGameState``
     (None for the fused trainer)}

The generator's state and the env's Philox keys (``VecState.key``,
``EnvState.ep_key``) are in it, so a resumed run continues the same random
streams and repeats the uninterrupted run bit for bit.

Runs over a mesh (``mesh=``, ``parallel/mesh.py``; the JAX package's
``_fetch_full`` and ``_reshard_like``): rank 0 writes the file a single
process would write while every rank waits at a barrier.  The generator
and the replicated leaves are equal on every rank; where a model axis
splits the trunk rows (the parameters themselves say so: the scan and
beer-game trainers split them, ``make_ppo_fused`` keeps them whole), the
rows and their Adam moments are gathered over the model group into the
global parameters; the env lanes (a scan trainer's ``EnvState``
or the beer game's ``BeerGameState``) are gathered over the data axis into
global lane order on host copies.  Restoring slices the rank's rows and
lanes (``place_train_state``), so a file moves between 1 process and any
``data x model`` mesh of the same trainer.
"""
from __future__ import annotations

import os
from typing import Any

import torch

from ..core.beergame import BeerGameState
from ..core.step import EnvState
from ..envs.vector import VecState
from ..models.policy import ActorCritic, DiscreteActorCritic, MLPConfig
from ..parallel.mesh import (barrier, gather_rows, host_all_gather,
                             local_rows, place_train_state, sharded,
                             tensor_parallel)

__all__ = ["FORMAT", "save_checkpoint", "restore_checkpoint"]

FORMAT = "gst-torch-ckpt-v1"


def _env_to_dict(env: VecState) -> dict:
    e = env.env._asdict()
    return {"key": list(env.key),
            "env": {k: (list(v) if k == "ep_key" and v is not None else v)
                    for k, v in e.items()}}


def _env_from_dict(d: dict, device) -> VecState:
    e = dict(d["env"])
    for k, v in e.items():
        if isinstance(v, torch.Tensor):
            e[k] = v.to(device)
    if "week" in e:                     # the beer game's state
        env = BeerGameState(**e)
    else:
        if e["ep_key"] is not None:
            e["ep_key"] = tuple(int(x) for x in e["ep_key"])
        env = EnvState(**e)
    return VecState(key=tuple(int(x) for x in d["key"]), env=env)


def _gather_env(mesh, env: VecState) -> VecState:
    """The ranks' env lanes in global order (CPU tensors): every tensor of
    the inner state concatenated along its trailing env axis, one shard a
    data index (the ranks of a model group hold the same lanes)."""
    inner = env.env
    return env._replace(env=type(inner)(*(
        torch.cat(host_all_gather(mesh, v)[::mesh.model], dim=-1)
        if isinstance(v, torch.Tensor) and v.dim() >= 1 else v
        for v in inner)))


def _split_rows(mesh, params) -> bool:
    """Whether ``params`` holds the rank's rows of its trunks (fewer than
    the hidden width) rather than whole layers."""
    return (tensor_parallel(mesh)
            and params.actor[0].w.shape[0] != params.cfg.hidden[0])


def _is_trunk(name: str) -> bool:
    """Whether a parameter of the actor-critic's state dict is a trunk
    layer's (split over a model axis)."""
    return name.startswith(("actor.", "critic."))


def _global_params(mesh, params, opt_state: dict):
    """``(state dict, Adam state dict)`` of the whole net: the trunk rows
    and their moments gathered over the model group in one collective."""
    names = [n for n, _ in params.named_parameters()]
    sd = {k: v.detach() for k, v in params.state_dict().items()}
    moments = [(i, k) for i, n in enumerate(names) if _is_trunk(n)
               for k in ("exp_avg", "exp_avg_sq")
               if k in opt_state["state"].get(i, {})]
    keys = [n for n in names if _is_trunk(n)]
    full = gather_rows(mesh, [sd[n] for n in keys]
                       + [opt_state["state"][i][k] for i, k in moments])
    sd.update(zip(keys, full))
    state = {i: dict(v) for i, v in opt_state["state"].items()}
    for (i, k), x in zip(moments, full[len(keys):]):
        state[i][k] = x
    return sd, {**opt_state, "state": state}


def _local_params(mesh, params, sd: dict, opt_state: dict):
    """The rank's rows of a global state dict and Adam state dict."""
    names = [n for n, _ in params.named_parameters()]
    sd = {k: local_rows(mesh, v).clone() if _is_trunk(k) else v
          for k, v in sd.items()}
    state = {i: {k: (local_rows(mesh, x).clone() if _is_trunk(names[i])
                     and k in ("exp_avg", "exp_avg_sq") else x)
                 for k, x in v.items()}
             for i, v in opt_state["state"].items()}
    return sd, {**opt_state, "state": state}


def save_checkpoint(path: str, state: Any, step: int = 0, mesh=None) -> str:
    """Write ``state`` (a ``TrainState`` or ``FusedTrainState``) as
    ``<path>/step_<step>.pt``; returns the file.  With a ``mesh`` every rank
    calls it: the split trunks and the env lanes are gathered, rank 0
    writes, and every rank returns after the write."""
    cfg = state.params.cfg
    env = getattr(state, "env", None)
    if env is not None and sharded(mesh):
        env = _gather_env(mesh, env)
    params = {k: v.detach() for k, v in state.params.state_dict().items()}
    opt = state.opt.state_dict()
    if _split_rows(mesh, state.params):
        params, opt = _global_params(mesh, state.params, opt)
    mlp = {"obs_dim": cfg.obs_dim, "act_dim": cfg.act_dim,
           "hidden": list(cfg.hidden)}
    if isinstance(state.params, DiscreteActorCritic):
        mlp["n_choices"] = state.params.n_choices
    payload = {
        "format": FORMAT, "step": int(step), "kind": type(state).__name__,
        "mlp": mlp,
        "params": {k: v.cpu() for k, v in params.items()},
        "opt": opt,
        "gen": {"device": str(state.gen.device),
                "state": state.gen.get_state()},
        "env": None if env is None else _env_to_dict(env),
    }
    target = os.path.join(path, f"step_{int(step)}.pt")
    if mesh is None or mesh.rank == 0:
        os.makedirs(path, exist_ok=True)
        tmp = target + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, target)
    barrier(mesh)
    return target


def _resolve(path: str) -> str:
    """A ``step_N.pt`` file, or the highest step in a checkpoint dir."""
    if os.path.isdir(path):
        steps = [e for e in os.listdir(path)
                 if e.startswith("step_") and e.endswith(".pt")]
        if not steps:
            raise FileNotFoundError(f"no step_*.pt checkpoints under {path}")
        path = os.path.join(path, max(
            steps, key=lambda e: int(e[len("step_"):-len(".pt")])))
    return path


def restore_checkpoint(path: str, like: Any = None, mesh=None) -> Any:
    """Read a checkpoint written by ``save_checkpoint``.

    ``path`` is a ``step_N.pt`` file or the checkpoint directory, whose
    highest step is read.  With ``like`` (a freshly built train state of the
    same trainer) the parameters, the optimizer state and the generator are
    loaded into ``like``'s objects in place, and the state is returned with
    its env rebuilt on ``like``'s device; with a ``mesh``, the env's lanes
    are the rank's, and so are the trunk rows where ``like``'s are split
    (``like`` is the rank's state).
    Without it, the result
    is a dict:
    ``params`` an ``ActorCritic`` (a ``DiscreteActorCritic`` where the file
    holds ``n_choices``) on the CPU rebuilt from the stored ``MLPConfig``,
    plus ``step``, ``mlp``, ``opt``, ``gen`` and ``env`` as stored.
    """
    path = _resolve(path)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(payload, dict) and payload.get("format") == FORMAT):
        raise ValueError(f"{path} is not a {FORMAT} checkpoint")
    mlp = MLPConfig(payload["mlp"]["obs_dim"], payload["mlp"]["act_dim"],
                    tuple(payload["mlp"]["hidden"]))
    n_choices = payload["mlp"].get("n_choices")
    if like is None:
        params = (ActorCritic(mlp, device="cpu") if n_choices is None else
                  DiscreteActorCritic(mlp, n_choices, device="cpu"))
        params.load_state_dict(payload["params"])
        return {**payload, "params": params, "mlp": mlp}
    if type(like).__name__ != payload["kind"]:
        raise ValueError(f"{path} holds a {payload['kind']}, not a "
                         f"{type(like).__name__}")
    if (like.params.cfg != mlp
            or getattr(like.params, "n_choices", None) != n_choices):
        raise ValueError(f"{path} holds an actor-critic {mlp} with "
                         f"{n_choices} choices, not {like.params.cfg} with "
                         f"{getattr(like.params, 'n_choices', None)}")
    sd, opt = payload["params"], payload["opt"]
    if _split_rows(mesh, like.params):
        sd, opt = _local_params(mesh, like.params, sd, opt)
    like.params.load_state_dict(sd)
    like.opt.load_state_dict(opt)
    like.gen.set_state(payload["gen"]["state"])
    if payload["env"] is None:
        return like
    device = like.params.v.w.device
    state = like._replace(env=_env_from_dict(payload["env"], device))
    if sharded(mesh):
        state = place_train_state(mesh, state)
    want = [tuple(v.shape) for v in like.env.env
            if isinstance(v, torch.Tensor)]
    got = [tuple(v.shape) for v in state.env.env
           if isinstance(v, torch.Tensor)]
    if want != got:
        raise ValueError(f"{path} holds env lanes of shapes {got}; the state "
                         f"to restore into has {want}")
    return state
