"""Process groups and the data-parallel mesh, on ``torch.distributed``.

The counterpart of ``gym_supplychain_tpu/parallel/mesh.py``.  The JAX
package names a ``('data', 'model')`` mesh of devices and lets XLA emit the
collectives; here every process is one rank of a process group and holds
one slice of the env batch, and the trainers call the collectives
themselves (``learn/ppo.py``): the gradients and the loss averaged by one
``all_reduce`` a step, the advantage statistics and the metrics by
``all_reduce`` too.

* ``init_distributed`` joins the group (torchrun's ``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, or the arguments) and
  picks the backend by rule: NCCL where every rank of the host has a card
  of its own, gloo where ranks outnumber cards (two ranks time-share one
  card) or on the CPU.
* ``make_mesh`` is the group as a ``Mesh``: its data axis, its model axis
  (tensor parallelism is not ported: ``model > 1`` raises), the rank, the
  world size, the rank's device and the groups.
* The port's arrays are batch-trailing, as the JAX package's, so a rank's
  shard is the lanes ``lane_range(mesh, B)`` of the last axis
  (``trailing_sharding``'s counterpart); ``shard_vec_state`` and
  ``place_train_state`` slice a global state down to them, and the env
  streams take the shard's first global lane (``lane0``), so a sharded run
  draws what the unsharded one draws, lane for lane.
* Gloo runs only ``broadcast`` and ``all_reduce`` on CUDA tensors, so every
  other collective (the checkpoint's gather) runs on host copies over a
  gloo group (``host_all_gather``); ``replicated`` checks that a tensor is
  bit-equal on every rank.

Every collective and barrier has the group's deadline (``TIMEOUT_S``): a
rank that dies fails the others instead of hanging them.
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["Mesh", "init_distributed", "make_mesh", "lane_range",
           "shard_vec_state", "place_train_state", "replicated",
           "all_reduce_mean_", "host_all_gather", "barrier", "sharded",
           "TIMEOUT_S"]

TIMEOUT_S = 600.0       # the deadline of every collective and barrier


def _rank_device(local_rank: int, device=None) -> torch.device:
    """A rank's device: ``cuda:(local_rank % cards)``, or the CPU where the
    caller asks for it.  Raises for a CUDA device where there is none."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a rank runs on a card unless the "
                           "caller asks for the CPU (device='cpu')")
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device=None) -> Optional[torch.device]:
    """Join the process group; a no-op for one process (returns None).

    The arguments default to torchrun's environment: ``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and ``MASTER_ADDR`` /
    ``MASTER_PORT`` (``coordinator_address`` is ``host:port``).  The rank's
    device is ``cuda:(local_rank % cards)``, or the CPU where ``device``
    asks for it.  ``backend`` defaults to ``nccl`` where every rank of the
    host has a card of its own, and to ``gloo`` where ranks outnumber cards
    (NCCL refuses two ranks on one card) or on the CPU.  Returns the rank's
    device.
    """
    world = num_processes if num_processes is not None else _env_int(
        "WORLD_SIZE")
    if world is None or world <= 1:
        return None
    rank = process_id if process_id is not None else _env_int("RANK")
    if rank is None or not 0 <= rank < world:
        raise RuntimeError(f"rank {rank} of {world} processes: set RANK or "
                           "pass process_id")
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get(
            "MASTER_PORT")
        if not addr or not port:
            raise RuntimeError("no coordinator address: set MASTER_ADDR and "
                               "MASTER_PORT or pass coordinator_address")
        coordinator_address = f"{addr}:{port}"
    if not coordinator_address.startswith("tcp://"):
        coordinator_address = "tcp://" + coordinator_address
    local_rank = _env_int("LOCAL_RANK")
    local_rank = rank if local_rank is None else local_rank
    dev = _rank_device(local_rank, device)
    if backend is None:
        local_world = _env_int("LOCAL_WORLD_SIZE") or world
        backend = ("nccl" if dev.type == "cuda"
                   and local_world <= torch.cuda.device_count() else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dev


@dataclass
class Mesh:
    """The data-parallel mesh of this process: ``data`` ranks along the env
    batch, ``model`` 1 (tensor parallelism is not ported), this process's
    ``rank`` of ``world``, its ``device``, the process ``group`` the
    trainers' collectives run on, the gloo ``host_group`` for collectives
    on host copies, and ``stats``: the collectives issued (``calls``)."""
    data: int
    model: int
    rank: int
    world: int
    device: torch.device
    backend: str
    group: Any = None
    host_group: Any = None
    stats: dict = field(default_factory=lambda: {"calls": 0})


def make_mesh(data: Optional[int] = None, model: int = 1,
              device=None) -> Mesh:
    """The mesh over every process of the group (one process where none
    was joined): ``data`` defaults to the world size over ``model``.  The
    device is the rank's (``init_distributed``'s rule; ``device`` as
    there).  ``model > 1`` raises: the model axis (tensor parallelism over
    the policy's hidden units) is not ported."""
    if model != 1:
        raise NotImplementedError(
            f"model={model}: tensor parallelism (the mesh's model axis) is "
            "not ported to the PyTorch package yet")
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        backend = dist.get_backend()
    else:
        rank, world, backend = 0, 1, "none"
    data = world // model if data is None else data
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} processes")
    local_rank = _env_int("LOCAL_RANK")
    dev = _rank_device(rank if local_rank is None else local_rank, device)
    group = host_group = None
    if world > 1:
        group = dist.group.WORLD
        host_group = group if backend == "gloo" else dist.new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return Mesh(data=data, model=model, rank=rank, world=world, device=dev,
                backend=backend, group=group, host_group=host_group)


def lane_range(mesh: Optional[Mesh], B: int) -> Tuple[int, int]:
    """The rank's lanes ``[lo, hi)`` of a global env axis of ``B`` lanes
    (all of them without a mesh).  Raises where the ranks cannot hold equal
    shards."""
    if mesh is None:
        return 0, B
    if B % mesh.data:
        raise ValueError(f"batch {B} is not divisible by the data axis "
                         f"{mesh.data}")
    n = B // mesh.data
    return mesh.rank * n, (mesh.rank + 1) * n


def _slice_lanes(x, lo: int, hi: int):
    if isinstance(x, torch.Tensor) and x.dim() >= 1:
        return x[..., lo:hi].contiguous()
    return x


def shard_vec_state(mesh: Optional[Mesh], state):
    """A global ``VecState`` (or bare ``EnvState``) sliced to the rank's
    lanes: every tensor's trailing env axis; the Philox keys and the clock
    are the same on every rank."""
    inner = state.env if hasattr(state, "key") else state
    B = inner.stock.shape[-1]
    lo, hi = lane_range(mesh, B)
    inner = type(inner)(*(_slice_lanes(v, lo, hi) for v in inner))
    return state._replace(env=inner) if hasattr(state, "key") else inner


def place_train_state(mesh: Optional[Mesh], state):
    """A global train state placed on the mesh: the parameters, the Adam
    state and the generator stay whole on every rank (the trainers keep
    them equal), the scan trainer's env lanes are sliced
    (``shard_vec_state``)."""
    if getattr(state, "env", None) is None:
        return state
    return state._replace(env=shard_vec_state(mesh, state.env))


def sharded(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` spans more than one process (the collectives are
    no-ops otherwise)."""
    return mesh is not None and mesh.world > 1


def all_reduce_mean_(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the ranks, in place (one ``all_reduce``);
    ``x`` unchanged without a mesh."""
    if sharded(mesh):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
        x.div_(mesh.world)
        mesh.stats["calls"] += 1
    return x


def host_all_gather(mesh: Optional[Mesh], x: torch.Tensor
                    ) -> List[torch.Tensor]:
    """Every rank's ``x`` (equal shapes), in rank order, as CPU tensors:
    gathered on host copies over the gloo group."""
    x = x.detach().cpu().contiguous()
    if not sharded(mesh):
        return [x]
    out = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(out, x, group=mesh.host_group)
    return out


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank (over the gloo group, under its deadline)."""
    if sharded(mesh):
        dist.barrier(group=mesh.host_group)


def replicated(mesh: Optional[Mesh], x: torch.Tensor) -> bool:
    """Whether ``x`` is bit-equal on every rank: rank 0's bytes broadcast
    and compared, the verdicts all-reduced (every rank gets the same
    answer)."""
    if not sharded(mesh):
        return True
    bits = x.detach().contiguous().view(-1).view(torch.uint8).to(torch.int32)
    ref = bits.clone()
    dist.broadcast(ref, src=0, group=mesh.group)
    ok = torch.tensor([int(torch.equal(bits, ref))], dtype=torch.int32,
                      device=bits.device)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=mesh.group)
    return bool(ok.item())
