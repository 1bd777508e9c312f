"""Whole-episode rollouts, rewards only: CUDA kernels, plain version, wrapper.

Replaces the TPU kernel ``_kernel`` of
``gym_supplychain_tpu/ops/supplychain_pallas.py`` (its ``pallas_call`` in
``_build``) in its three modes, under the JAX package's entry points without
``_pallas``: ``make_supplychain_episode`` (``seeded``, ``actions``: K6a,
rewards-only sweeps) and ``make_supplychain_policy_rollout`` (``policy``:
K4, the greedy rollout of the fused evaluator).  One launch runs one
``T``-step episode for every env from the episode's tables, demands
``[T+1, R, P, B]`` float32 and lead-times ``[T, K, B]`` int32 (stochastic
chains), and writes only the rewards ``[T, B]``.

* ``actions`` reads an action table ``[T, A, B]`` in [-1, 1] (the parity
  mode).
* ``seeded`` draws its actions from Philox4x32-10 keyed by the seed: the
  action row of step ``s`` is ``2u - 1`` of the first A words at counter
  ``(lane, s, block, 0)`` (``seeded_actions``), so ``seeded`` is
  ``actions`` fed that table, and that is its plain version.  The JAX
  package runs ``seeded`` on its fast-FP path; the port runs the exact
  sequence of the other modes (the fast-FP path is not ported).
* ``policy`` builds the observation, runs the actor trunk and the mu head
  (no critic, no noise), steps with ``tanh(mu)`` and writes the reward.
  The MLP accumulates in the order of ``_mlp_ordered``, so the kernel and
  the plain version agree bit for bit, as the collect kernel's policy
  modes do.

``seeded`` and ``actions`` (K6a) run the lane-group kernel without its
observation stream (``csrc/supplychain_episode.cu`` on
``csrc/supplychain_lanes.cuh``, the step K1's ``random``/``actions`` and K5
share: each env on a group of 4, 8 or 16 lanes, 8 envs a block), launched
through ``ops/supplychain_dense.py``'s ``launch_lanes`` on the descriptor
``dense_descriptor`` makes.  ``policy`` (K4) runs ``sc_greedy_kernel``
(``csrc/supplychain_collect.cu``) on the one-thread step of
``csrc/supplychain_step.cuh``, the chain descriptor ``chain_descriptor``
and the weight packing of ``ops/_mlp.py``.  What bounds them is set out at
the top of those files.  The plain version is an eager loop over
``core/step.py`` in table mode; the wrapper takes it only for tensors on
the CPU, and launches the kernel or raises for CUDA ones.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.compile import CompiledChain
from ..core.step import make_supplychain_kernels
from ..models.policy import flat_params, split_params
from ..rng.device import philox_uniform
from ._mlp import LAYOUT_INTS, SMEM_MAX, MlpLayout
from .supplychain_collect import (_PK_ENVS, DESC_BYTES, _check, _mlp_ordered,
                                  chain_descriptor, resolve_device, seed_key)
from .supplychain_dense import dense_descriptor, lane_block, launch_lanes

__all__ = ["make_supplychain_episode", "make_supplychain_policy_rollout",
           "launch_supplychain_episode", "launch_supplychain_greedy",
           "supplychain_episode_plain", "seeded_actions", "greedy_smem_bytes"]

_MODES = ("actions", "seeded")            # K6a's modes


def seeded_actions(cc: CompiledChain, seed: int, B: int, device):
    """The action table ``[T, A, B]`` that ``seeded`` mode draws."""
    u = philox_uniform(seed_key(seed), range(cc.T), cc.A, B, device)
    return 2.0 * u - 1.0


def _actor(params, device):
    """Actor trunk and mu head as float32 ``(w, b)`` pairs on ``device``."""
    flat = [p.detach().to(device=device, dtype=torch.float32)
            for p in flat_params(params)]
    actor, mu, _, _, _ = split_params(flat)
    return actor + [mu]


def supplychain_episode_plain(cc: CompiledChain, B: int, mode: str,
                              demands, leadtimes=None, actions=None,
                              seed: int = 0, params=None):
    """Plain version: an eager loop over ``core/step.py`` in table mode on
    the tables' device.  Returns ``(rewards [T, B], final stock [N, P, B])``.
    """
    if mode not in ("seeded", "actions", "policy"):
        raise ValueError(f"unknown mode {mode!r}")
    device = demands.device
    reset_fn, step_fn, obs_fn = make_supplychain_kernels(
        cc, dtype=torch.float32, device=device)
    if mode == "seeded":
        actions = seeded_actions(cc, seed, B, device)
    if mode == "policy":
        actor = _actor(params, device)
    st = reset_fn(demands, leadtimes, B)
    obs = obs_fn(st) if mode == "policy" else None
    rew = torch.empty((cc.T, B), dtype=torch.float32, device=device)
    for t in range(cc.T):
        a = torch.tanh(_mlp_ordered(actor, obs)) if mode == "policy" \
            else actions[t]
        st, out = step_fn(st, a)
        rew[t] = out.reward
        obs = out.obs
    return rew, st.stock


def _check_tables(cc, B, device, demands, leadtimes):
    _check(demands, "demands", torch.float32, (cc.T + 1, cc.R, cc.P, B),
           device)
    if cc.stochastic_leadtimes:
        _check(leadtimes, "leadtimes", torch.int32, (cc.T, cc.K, B), device)
        return leadtimes.data_ptr()
    return None


def _cuda_device(desc):
    device = desc.device
    if device.type != "cuda":
        raise ValueError("the episode kernels run on a CUDA device")
    return device


def launch_supplychain_episode(desc: torch.Tensor, cc: CompiledChain, B: int,
                               mode: str, demands, leadtimes=None,
                               actions=None, seed: int = 0):
    """Launch the CUDA episode kernel (``seeded``, ``actions``: the
    lane-group kernel without its observation stream) on the current
    stream.  ``desc`` is ``dense_descriptor(cc)`` on the card.  Returns
    ``(rewards [T, B], final stock [N, P, B])``."""
    if mode not in _MODES:
        raise ValueError(f"mode {mode!r}: this launcher takes 'seeded' and "
                         "'actions' (launch_supplychain_greedy takes "
                         "'policy')")
    device = _cuda_device(desc)
    lt_ptr = _check_tables(cc, B, device, demands, leadtimes)
    act_ptr = None
    if mode == "actions":
        _check(actions, "actions", torch.float32, (cc.T, cc.A, B), device)
        act_ptr = actions.data_ptr()
    _, rew, stock = launch_lanes(desc, cc, "episode", cc.T, B, mode, seed,
                                 (demands.data_ptr(), lt_ptr, act_ptr))
    launch_supplychain_episode.launches += 1
    return rew, stock


launch_supplychain_episode.launches = 0


def greedy_smem_bytes(layout: MlpLayout) -> int:
    """Dynamic shared memory of the greedy kernel: the packed actor
    section, the obs tile, two hidden tiles and the head tile for a block of
    32 envs.  Raises where the block would exceed the card's shared memory
    (the chain descriptor and the layout sit beside it)."""
    floats = layout.wsec[0] + _PK_ENVS * (layout.O + 2 * max(layout.hidden)
                                          + layout.head_rows[0])
    dyn = 4 * floats
    if dyn + DESC_BYTES + 4 * LAYOUT_INTS > SMEM_MAX:
        raise NotImplementedError(
            f"actor O={layout.O}, A={layout.A}, hidden={layout.hidden} needs "
            f"{dyn + DESC_BYTES + 4 * LAYOUT_INTS} bytes of shared memory per "
            f"block; the greedy kernel has {SMEM_MAX}")
    return dyn


def launch_supplychain_greedy(desc: torch.Tensor, cc: CompiledChain,
                              layout: MlpLayout, layout_dev: torch.Tensor,
                              weights: torch.Tensor, B: int, demands,
                              leadtimes=None):
    """Launch the CUDA greedy-policy kernel on the current stream.
    ``layout_dev`` is ``layout.ints`` and ``weights`` ``layout.pack(flat)``
    (the kernel reads its actor section), both on the card.  Returns
    ``(rewards [T, B], final stock [N, P, B])``."""
    from ._build import check, library

    device = _cuda_device(desc)
    _check(desc, "desc", torch.uint8, (DESC_BYTES,), device)
    if (layout.O, layout.A) != (cc.obs_dim, cc.A):
        raise ValueError(f"actor for O={layout.O}, A={layout.A}; the chain "
                         f"has O={cc.obs_dim}, A={cc.A}")
    _check(layout_dev, "layout", torch.int32, (LAYOUT_INTS,), device)
    _check(weights, "weights", torch.float32,
           (layout.wsec[0] + layout.wsec[1],), device)
    smem = greedy_smem_bytes(layout)
    lt_ptr = _check_tables(cc, B, device, demands, leadtimes)
    lib = library()
    if lib.sc_chain_bytes() != DESC_BYTES:
        raise RuntimeError("chain descriptor layout differs from the kernel's")
    if lib.mlp_layout_ints() != LAYOUT_INTS:
        raise RuntimeError("MLP layout differs from the kernel's")
    rew = torch.empty((cc.T, B), dtype=torch.float32, device=device)
    stock = torch.empty((cc.N, cc.P, B), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.sc_greedy_launch(
            desc.data_ptr(), DESC_BYTES, layout_dev.data_ptr(),
            weights.data_ptr(), smem, B, demands.data_ptr(), lt_ptr,
            rew.data_ptr(), stock.data_ptr(), stream)
    check(code, "supplychain greedy rollout")
    launch_supplychain_greedy.launches += 1
    return rew, stock


launch_supplychain_greedy.launches = 0


def _setup(cc: CompiledChain, T: int, device, words_fn):
    """Checks shared by both runner makers -> (device, the kernel's chain
    descriptor ``words_fn(cc)`` on the card or None for the CPU)."""
    if T != cc.T:
        raise ValueError(f"T={T} must equal the chain horizon cc.T={cc.T}")
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    device = resolve_device(device)
    # unsupported chains fail here, when the runner is built
    words = words_fn(cc)
    desc = (torch.as_tensor(words, device=device)
            if device.type == "cuda" else None)
    return device, desc


def _lane_words(cc: CompiledChain):
    lane_block(cc, "episode")
    return dense_descriptor(cc)


def _on(x, name, dtype, device):
    """``x`` as a tensor on ``device``: numpy is put there, a tensor on
    another device is rejected."""
    if not isinstance(x, torch.Tensor):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the runner on {device}")
    return x


def _tables_of(cc, device, demands, rest):
    """Runner arguments ``demands, [leadtimes,] last`` -> ``(demands,
    leadtimes or None, last)``, the tables as tensors on ``device``."""
    if cc.stochastic_leadtimes:
        leadtimes, last = rest
        leadtimes = _on(leadtimes, "leadtimes", torch.int32, device)
    else:
        (last,), leadtimes = rest, None
    return _on(demands, "demands", torch.float32, device), leadtimes, last


def make_supplychain_episode(cc: CompiledChain, T: int, B: int,
                             device="cuda"):
    """Rewards-only episode runners on ``device``: ``(run_seeded,
    run_actions)`` with

    * ``run_seeded(demands [T+1,R,P,B], [leadtimes [T,K,B],] seed)``;
    * ``run_actions(demands, [leadtimes,] actions [T,A,B])``;

    each returning the rewards ``[T, B]``.  A CUDA device launches the
    kernel; the CPU runs the plain version.
    """
    device, desc = _setup(cc, T, device, _lane_words)

    def _run(mode, demands, rest):
        dem, lt, last = _tables_of(cc, device, demands, rest)
        kw = (dict(seed=int(last)) if mode == "seeded"
              else dict(actions=_on(last, "actions", torch.float32, device)))
        if desc is not None:
            return launch_supplychain_episode(desc, cc, B, mode, dem, lt,
                                              **kw)[0]
        return supplychain_episode_plain(cc, B, mode, dem, lt, **kw)[0]

    def run_seeded(demands, *rest):
        return _run("seeded", demands, rest)

    def run_actions(demands, *rest):
        return _run("actions", demands, rest)

    return run_seeded, run_actions


def make_supplychain_policy_rollout(cc: CompiledChain, T: int, B: int,
                                    hidden=(128, 128), device="cuda"):
    """The greedy policy-in-the-loop episode on ``device``:
    ``run_policy(demands [T+1,R,P,B], [leadtimes [T,K,B],] params) ->
    rewards [T, B]``, ``params`` an ``ActorCritic`` of widths ``hidden`` on
    ``device`` or its flat list (only the actor trunk and the mu head are
    used).  A CUDA device launches the kernel; the CPU runs the plain
    version.
    """
    device, desc = _setup(cc, T, device, chain_descriptor)
    layout = MlpLayout(cc.obs_dim, cc.A, hidden)
    if desc is not None:
        greedy_smem_bytes(layout)
        layout_dev = torch.as_tensor(layout.ints, device=device)

    def run_policy(demands, *rest):
        dem, lt, params = _tables_of(cc, device, demands, rest)
        flat = flat_params(params)
        for p in flat:
            if p.device != device:
                raise ValueError(f"params on {p.device}, the runner on "
                                 f"{device}")
        if desc is not None:
            return launch_supplychain_greedy(desc, cc, layout, layout_dev,
                                             layout.pack(flat), B, dem,
                                             lt)[0]
        return supplychain_episode_plain(cc, B, "policy", dem, lt,
                                         params=flat)[0]

    return run_policy
