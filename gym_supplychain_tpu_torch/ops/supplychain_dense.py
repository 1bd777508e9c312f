"""Trajectory collection for large chains (K5): CUDA kernel, plain version,
wrapper.

Replaces the TPU kernel ``make_supplychain_dense_collect_pallas`` of
``gym_supplychain_tpu/ops/supplychain_pallas_dense.py`` (``_kernel``), the
collect kernel of the 26-40-node topologies (``sc-Nperstage-multiproduct-v0``
at ``[5, 4, 7, 10]`` nodes per echelon, 4 products, or 10 per echelon, 2
products; ``sc-2perstage-multiproduct-v0`` at 10 products), which the
collect kernel of ``ops/supplychain_collect.py`` refuses.  ``episodes``
back-to-back episodes run in one launch with auto-reset at every boundary;
every step emits its pre-action observation ``obs [S, O, B]`` and its
reward ``reward [S, B]`` (S = episodes * T).

* ``actions`` reads per-step tables: demands ``[S, R, P, B]`` float32,
  lead-times ``[S, K, B]`` int32 (stochastic chains only) and actions
  ``[S, A, B]`` float32 in [-1, 1]; table row s feeds step s.
* ``random`` draws those rows in the kernel from Philox4x32-10 keyed by the
  seed, as the collect kernel's ``random`` does: at counter ``(lane, step,
  block, 0)``, A action uniforms, then K lead-time uniforms (stochastic
  chains), then R*P demand uniforms.  It is ``actions`` fed the tables
  ``philox_tables`` makes, and that is its plain version.  The JAX dense
  kernel draws lead-times per use from the TPU's generator instead; no
  stream of the port matches the TPU's value for value anyway.

The kernel (``csrc/supplychain_dense.cu``) runs one thread per env with its
state in shared-memory tiles and reads each input where the step uses it,
so it builds none of the JAX kernel's pre-gathered ``[S, N, P, Dmax, B]``
tables.  Its step is the collect kernels' (``csrc/supplychain_step.cuh``),
so it follows the same float rules and matches the plain version, an eager
loop over ``core/step.py`` (``supplychain_collect_plain``), bit for bit in
the dynamics; rewards differ in the order of the cost sum (~1e-7 relative).
The wrapper takes the plain version only for a tensor on the CPU, and
launches the kernel or raises for a CUDA one.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.compile import CompiledChain
from ._mlp import SMEM_MAX
from .supplychain_collect import (_check, _check_tables, _desc_fields,
                                  check_kernel_support, check_uniform_demand,
                                  descriptor_words, resolve_device, seed_key,
                                  supplychain_collect_plain)

__all__ = ["make_supplychain_dense_collect", "launch_supplychain_dense",
           "supplychain_dense_collect_plain", "dense_descriptor",
           "dense_block", "DENSE_MAX"]

_MODES = {"random": 0, "actions": 1}      # the kernel's mode numbers
# the kernel's size limits (DN_MAX_* of csrc/supplychain_dense.cu; K and A
# bound nothing in the kernel, they are its tested range)
DENSE_MAX = dict(N=64, P=16, NP=128, D=16, ND=1024, NPD=2048, RING=8, K=512,
                 A=1024, RP=128, CDF=8)
_DN_FIELDS = _desc_fields(DENSE_MAX)
DN_DESC_BYTES = 4 * sum(c for _, _, c in _DN_FIELDS)
_WARP = 32


def dense_descriptor(cc: CompiledChain) -> np.ndarray:
    """The chain as the bytes of ``DnChain`` (uint8 array); raises for a
    chain beyond ``DENSE_MAX`` or with a negative capacity."""
    check_kernel_support(cc, DENSE_MAX, "the dense collect kernel")
    return descriptor_words(cc, _DN_FIELDS)


def dense_block(cc: CompiledChain):
    """``(E, shared bytes)``: the envs a block of the kernel holds (32, or
    fewer where their state would not fit) and its dynamic shared memory,
    the tiles stock ``[N*P]``, ring and delivery sums ``[RING*N*P]`` and
    the demand row ``[R*P]`` for each env."""
    per_env = 4 * (cc.N * cc.P * (1 + 2 * (cc.H + 1)) + cc.R * cc.P)
    E = min(_WARP, SMEM_MAX // per_env)
    if E < 1:
        raise NotImplementedError(f"one env's state takes {per_env} bytes of "
                                  f"shared memory; a block has {SMEM_MAX}")
    return E, E * per_env


def supplychain_dense_collect_plain(cc: CompiledChain, episodes: int, B: int,
                                    mode: str, seed: int = 0, demands=None,
                                    leadtimes=None, actions=None,
                                    device=None):
    """Plain version: the eager ``core/step.py`` loop with auto-reset of
    ``supplychain_collect_plain``, which takes any chain.  Returns ``(obs
    [S,O,B], reward [S,B], final stock [N,P,B])``."""
    if mode not in _MODES:
        raise ValueError(f"unknown dense collect mode {mode!r}")
    return supplychain_collect_plain(cc, episodes, B, mode, seed=seed,
                                     demands=demands, leadtimes=leadtimes,
                                     actions=actions, device=device)


def launch_supplychain_dense(desc: torch.Tensor, cc: CompiledChain, S: int,
                             B: int, mode: str, seed: int = 0, demands=None,
                             leadtimes=None, actions=None):
    """Launch the CUDA dense collect kernel on the current stream.

    ``desc`` is ``dense_descriptor(cc)`` as a uint8 tensor on the card.
    Returns ``(obs [S,O,B], reward [S,B], final stock [N,P,B])``.
    """
    from ._build import check, library

    if mode not in _MODES:
        raise ValueError(f"unknown dense collect mode {mode!r}")
    device = desc.device
    if device.type != "cuda":
        raise ValueError("the dense collect kernel runs on a CUDA device")
    _check(desc, "desc", torch.uint8, (DN_DESC_BYTES,), device)
    ptrs = (None, None, None)
    if mode == "random":
        check_uniform_demand(cc)
    else:
        ptrs = _check_tables(cc, S, B, device, demands, leadtimes, actions,
                             "actions")
    E, smem = dense_block(cc)
    lib = library()
    if lib.dn_chain_bytes() != DN_DESC_BYTES:
        raise RuntimeError("chain descriptor layout differs from the kernel's")
    f32 = dict(dtype=torch.float32, device=device)
    obs = torch.empty((S, cc.obs_dim, B), **f32)
    rew = torch.empty((S, B), **f32)
    stock = torch.empty((cc.N, cc.P, B), **f32)
    k0, k1 = seed_key(seed)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.sc_dense_launch(
            desc.data_ptr(), DN_DESC_BYTES, _MODES[mode], S, B, E, smem,
            *ptrs, k0, k1, obs.data_ptr(), rew.data_ptr(), stock.data_ptr(),
            stream)
    check(code, "supplychain dense collect")
    launch_supplychain_dense.launches += 1
    return obs, rew, stock


launch_supplychain_dense.launches = 0


def make_supplychain_dense_collect(cc: CompiledChain, T: int, B: int,
                                   mode: str = "random", episodes: int = 1,
                                   device="cuda"):
    """Trajectory collection for large chains over ``episodes``
    back-to-back episodes, on ``device``:

    * ``random``: ``run(seed) -> (obs [S,O,B], reward [S,B])``;
    * ``actions``: ``run(demands [S,R,P,B], [leadtimes [S,K,B],]
      actions [S,A,B]) -> (obs, reward)``, table row s feeding step s.

    Numpy tables are put on ``device``; tensors on another device are
    rejected.  A CUDA device launches the kernel; the CPU runs the plain
    version.  A bad mode, ``T != cc.T``, a chain beyond the kernel's limits
    or a negative capacity raise here.
    """
    if mode not in _MODES:
        raise ValueError(f"unknown dense collect mode {mode!r}")
    if T != cc.T:
        # the remaining-time obs feature is normalized by the episode length
        raise ValueError(f"T={T} must equal the chain horizon cc.T={cc.T}")
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    device = resolve_device(device)
    S = episodes * T
    # unsupported chains fail here, when the collector is built
    words = dense_descriptor(cc)
    dense_block(cc)
    if mode == "random":
        check_uniform_demand(cc)
    desc = (torch.as_tensor(words, device=device)
            if device.type == "cuda" else None)

    def _run(**kw):
        if desc is not None:
            obs, rew, _ = launch_supplychain_dense(desc, cc, S, B, mode, **kw)
        else:
            obs, rew, _ = supplychain_dense_collect_plain(
                cc, episodes, B, mode, device=device, **kw)
        return obs, rew

    if mode == "random":
        return lambda seed: _run(seed=int(seed))

    def _tensor(x, name, dtype):
        if not isinstance(x, torch.Tensor):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, the collector on "
                             f"{device}")
        return x

    def run(demands, *rest):
        if cc.stochastic_leadtimes:
            leadtimes, actions = rest
            leadtimes = _tensor(leadtimes, "leadtimes", torch.int32)
        else:
            (actions,), leadtimes = rest, None
        return _run(demands=_tensor(demands, "demands", torch.float32),
                    leadtimes=leadtimes,
                    actions=_tensor(actions, "actions", torch.float32))
    return run
