"""Process groups and the ``(data, model)`` mesh, on ``torch.distributed``.

The counterpart of ``gym_supplychain_tpu/parallel/mesh.py``.  The JAX
package names a ``('data', 'model')`` mesh of devices and lets XLA emit the
collectives; here every process is one rank of a process group and the
trainers call the collectives themselves (``learn/ppo.py``).

* ``init_distributed`` joins the group (torchrun's ``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, or the arguments) and
  picks the backend by rule: NCCL where every rank of the host has a card
  of its own, gloo where ranks outnumber cards (two ranks time-share one
  card) or on the CPU.
* ``make_mesh(data, model)`` lays the ranks out as JAX's
  ``devices.reshape(data, model)``: rank ``r`` is ``(d, m) = divmod(r,
  model)``.  The ``data`` axis splits the env batch: the ranks of one
  ``data_group`` (the same ``m``) hold different lanes and average their
  gradients, advantage statistics and metrics (``all_reduce_mean_``).  The
  ``model`` axis is tensor parallelism over the policy's hidden units: the
  ranks of one ``model_group`` (the same ``d``) run the same lanes, each
  holding its rows of every trunk layer (``models/policy.py``), and
  exchange activations with ``gather_rows`` / ``reduce_scatter_rows``
  (all-gather along the hidden axis; sum, then keep the rank's rows).
* The port's arrays are batch-trailing, as the JAX package's, so a rank's
  shard is the lanes ``lane_range(mesh, B)`` of the last axis (by its data
  index; ``trailing_sharding``'s counterpart); ``shard_vec_state`` and
  ``place_train_state`` slice a global state down to them, and the env
  streams take the shard's first global lane (``lane0``), so a sharded run
  draws what the unsharded one draws, lane for lane.
* Gloo runs only ``broadcast`` and ``all_reduce`` on CUDA tensors, so the
  model group's gather is an ``all_reduce`` of a zeroed buffer into which
  each rank writes its rows (summed as int32 bit patterns: exact, ``-0.0``
  included) and its reduce-scatter an ``all_reduce`` and a slice, on either
  backend.  The checkpoint's gather of env lanes runs on host copies over a gloo group
  (``host_all_gather``); ``replicated`` checks that a tensor is bit-equal on
  every rank.

Every collective and barrier has the group's deadline (``TIMEOUT_S``): a
rank that dies fails the others instead of hanging them.  ``mesh.stats``
counts the trainers' collectives over each group (``data``, ``model``), and
so do the always-on counters of ``utils/profiling.py``:
``collective.<axis>`` and ``collective.<axis>_bytes`` (the bytes each rank
hands the collective).  ``all_reduce_mean_`` and ``model_all_reduce_`` run
in the program spans ``mesh.data_all_reduce`` and ``mesh.model_all_reduce``.
Without a data or model axis nothing is counted and no span is opened.
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.profiling import count, span

__all__ = ["Mesh", "init_distributed", "make_mesh", "lane_range",
           "shard_vec_state", "place_train_state", "replicated",
           "all_reduce_mean_", "model_all_reduce_", "gather_rows",
           "reduce_scatter_rows", "local_rows", "host_all_gather", "barrier",
           "sharded", "data_parallel", "tensor_parallel", "TIMEOUT_S"]

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
    """This process's place on the ``data x model`` mesh: ``rank`` of
    ``world`` at ``(data_index, model_index) = divmod(rank, model)``, its
    ``device``, the process ``group`` of every rank, the gloo
    ``host_group`` for collectives on host copies, the ``data_group`` (the
    ranks of this model index; None where ``data`` is 1) and the
    ``model_group`` (the ranks of this data index; None where ``model`` is
    1), and ``stats``: the collectives run over each."""
    data: int
    model: int
    rank: int
    world: int
    device: torch.device
    backend: str
    group: Any = None
    host_group: Any = None
    data_group: Any = None
    model_group: Any = None
    stats: dict = field(default_factory=lambda: {"data": 0, "model": 0})

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model


def _timeout():
    return datetime.timedelta(seconds=TIMEOUT_S)


def _axis_groups(rank: int, data: int, model: int):
    """``(data_group, model_group)`` of ``rank``.  ``dist.new_group`` is
    collective, so every rank creates every subgroup, in one order: the
    data groups by model index, then the model groups by data index."""
    if model == 1:
        return dist.group.WORLD, None
    if data == 1:
        return None, dist.group.WORLD
    groups = {}
    for m in range(model):
        groups["data", m] = dist.new_group(
            [d * model + m for d in range(data)], timeout=_timeout())
    for d in range(data):
        groups["model", d] = dist.new_group(
            [d * model + m for m in range(model)], timeout=_timeout())
    return groups["data", rank % model], groups["model", rank // model]


def make_mesh(data: Optional[int] = None, model: int = 1,
              device=None) -> Mesh:
    """The ``data x model`` mesh over every process of the group (one
    process where none was joined): ``data`` defaults to the world size
    over ``model``; a world that is not ``data * model`` raises
    ``ValueError``.  The device is the rank's (``init_distributed``'s rule;
    ``device`` as there)."""
    if model < 1 or (data is not None and data < 1):
        raise ValueError(f"mesh {data}x{model}: both axes must be >= 1")
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        backend = dist.get_backend()
    else:
        rank, world, backend = 0, 1, "none"
    if data is None:
        data = max(1, world // model)
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} processes")
    local_rank = _env_int("LOCAL_RANK")
    dev = _rank_device(rank if local_rank is None else local_rank, device)
    group = host_group = data_group = model_group = None
    if world > 1:
        group = dist.group.WORLD
        host_group = group if backend == "gloo" else dist.new_group(
            backend="gloo", timeout=_timeout())
        data_group, model_group = _axis_groups(rank, data, model)
    return Mesh(data=data, model=model, rank=rank, world=world, device=dev,
                backend=backend, group=group, host_group=host_group,
                data_group=data_group, model_group=model_group)


def lane_range(mesh: Optional[Mesh], B: int) -> Tuple[int, int]:
    """The rank's lanes ``[lo, hi)`` of a global env axis of ``B`` lanes,
    by its data index (all of them without a mesh; the ranks of a model
    group share theirs).  Raises where the data axis cannot hold equal
    shards."""
    if mesh is None:
        return 0, B
    if B % mesh.data:
        raise ValueError(f"batch {B} is not divisible by the data axis "
                         f"{mesh.data}")
    n = B // mesh.data
    return mesh.data_index * n, (mesh.data_index + 1) * n


def _slice_lanes(x, lo: int, hi: int):
    if isinstance(x, torch.Tensor) and x.dim() >= 1:
        return x[..., lo:hi].contiguous()
    return x


def shard_vec_state(mesh: Optional[Mesh], state):
    """A global ``VecState`` (or a bare ``EnvState`` or ``BeerGameState``)
    sliced to the rank's lanes: every tensor's trailing env axis; the
    Philox keys and the clock are the same on every rank."""
    inner = state.env if hasattr(state, "key") else state
    B = next(v for v in inner
             if isinstance(v, torch.Tensor) and v.dim() >= 1).shape[-1]
    lo, hi = lane_range(mesh, B)
    inner = type(inner)(*(_slice_lanes(v, lo, hi) for v in inner))
    return state._replace(env=inner) if hasattr(state, "key") else inner


def place_train_state(mesh: Optional[Mesh], state):
    """A global train state placed on the mesh: the env lanes are sliced
    to the rank's (``shard_vec_state``); the parameters, the Adam state
    and the generator are left as they are (the checkpoint restores a
    model axis's trunk rows itself)."""
    if getattr(state, "env", None) is None:
        return state
    return state._replace(env=shard_vec_state(mesh, state.env))


def sharded(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` spans more than one process."""
    return mesh is not None and mesh.world > 1


def data_parallel(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` splits the env batch over more than one rank."""
    return mesh is not None and mesh.data > 1


def tensor_parallel(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` splits the hidden units over more than one rank."""
    return mesh is not None and mesh.model > 1


def _count(mesh: Mesh, axis: str, x: torch.Tensor) -> None:
    """One collective over ``axis``'s group on the buffer ``x``."""
    mesh.stats[axis] += 1
    count(f"collective.{axis}")
    count(f"collective.{axis}_bytes", x.numel() * x.element_size())


def all_reduce_mean_(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the data axis, in place (one ``all_reduce`` over
    the data group); ``x`` unchanged without one."""
    if data_parallel(mesh):
        with span("mesh.data_all_reduce"):
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.data_group)
            x.div_(mesh.data)
        _count(mesh, "data", x)
    return x


def model_all_reduce_(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the model group, in place; unchanged without a
    model axis."""
    if tensor_parallel(mesh):
        with span("mesh.model_all_reduce"):
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.model_group)
        _count(mesh, "model", x)
    return x


def local_rows(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The rank's rows of ``x`` (its leading axis split over the model
    axis, in model order); ``x`` without a model axis."""
    if not tensor_parallel(mesh):
        return x
    if x.shape[0] % mesh.model:
        raise ValueError(f"{x.shape[0]} rows are not divisible by the model "
                         f"axis {mesh.model}")
    r = x.shape[0] // mesh.model
    return x[mesh.model_index * r:(mesh.model_index + 1) * r]


def _same_dtype(xs) -> torch.dtype:
    dtypes = {x.dtype for x in xs}
    if len(dtypes) != 1:
        raise ValueError(f"one packed collective takes one dtype, got "
                         f"{sorted(map(str, dtypes))}")
    return dtypes.pop()


def gather_rows(mesh: Optional[Mesh], xs: Sequence[torch.Tensor]
                ) -> List[torch.Tensor]:
    """Every ``x [r, ...]`` of ``xs`` gathered over the model group into
    ``[model * r, ...]`` (rank ``m``'s rows at ``m * r``), all in one
    collective on one packed buffer."""
    xs = list(xs)
    if not tensor_parallel(mesh) or not xs:
        return xs
    M, m = mesh.model, mesh.model_index
    _same_dtype(xs)
    flat = torch.cat([x.reshape(-1) for x in xs])
    out = flat.new_zeros((M, flat.numel()))
    out[m] = flat
    bits = out.view(torch.int32) if out.element_size() == 4 else out
    dist.all_reduce(bits, op=dist.ReduceOp.SUM, group=mesh.model_group)
    _count(mesh, "model", bits)
    full, off = [], 0
    for x in xs:
        n = x.numel()
        full.append(out[:, off:off + n].reshape((M * x.shape[0],)
                                                + tuple(x.shape[1:])))
        off += n
    return full


def reduce_scatter_rows(mesh: Optional[Mesh], gs: Sequence[torch.Tensor]
                        ) -> List[torch.Tensor]:
    """Every ``g [model * r, ...]`` of ``gs`` summed over the model group,
    of which the rank keeps its rows ``[r, ...]``: ``gather_rows``'
    adjoint, in one collective on one packed buffer."""
    gs = list(gs)
    if not tensor_parallel(mesh) or not gs:
        return gs
    M, m = mesh.model, mesh.model_index
    _same_dtype(gs)
    packed = torch.cat([g.reshape(M, -1) for g in gs], dim=1)
    dist.all_reduce(packed, op=dist.ReduceOp.SUM, group=mesh.model_group)
    mine = packed[m]
    _count(mesh, "model", packed)
    local, off = [], 0
    for g in gs:
        n = g.numel() // M
        local.append(mine[off:off + n].reshape((g.shape[0] // M,)
                                               + tuple(g.shape[1:])))
        off += n
    return local


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
