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

Both kernels run the lane-group step of ``csrc/supplychain_lanes.cuh``
(the step K1 and K5 share: each env on a group of 4, 8 or 16 lanes, its
state in shared memory) on the descriptor ``dense_descriptor`` makes.
``seeded`` and ``actions`` (K6a) run the lane-group kernel without its
observation stream (``csrc/supplychain_episode.cu``, 8 envs a block),
launched through ``ops/supplychain_dense.py``'s ``launch_lanes``.
``policy`` (K4) runs the policy lane kernel (``csrc/supplychain_policy.cu``)
with the actor alone, launched through ``launch_policy_lanes``: E envs a
block (``policy_block``), the packed actor (``ops/_mlp.py``) in shared
memory once a block, the MLP run by every thread of the block.  What bounds
them is set out at the top of those files.  The plain version is an eager
loop over ``core/step.py`` in table mode; the wrapper takes it only for
tensors on the CPU, and launches the kernel or raises for CUDA ones.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.compile import CompiledChain
from ..core.step import make_supplychain_kernels
from ..models.policy import flat_params, split_params
from ..rng.device import philox_uniform
from ..utils.profiling import count, span
from ._mlp import MlpLayout
from .supplychain_collect import (_check, _mlp_ordered, resolve_device,
                                  seed_key)
from .supplychain_dense import (dense_descriptor, lane_block, launch_lanes,
                                launch_policy_lanes, policy_block)

__all__ = ["make_supplychain_episode", "make_supplychain_policy_rollout",
           "launch_supplychain_episode", "launch_supplychain_greedy",
           "supplychain_episode_plain", "seeded_actions"]

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
    count("launch.supplychain_episode")
    return rew, stock


def launch_supplychain_greedy(desc: torch.Tensor, cc: CompiledChain,
                              layout: MlpLayout, layout_dev: torch.Tensor,
                              weights: torch.Tensor, B: int, demands,
                              leadtimes=None):
    """Launch the CUDA greedy-policy kernel (the policy lane kernel with the
    actor alone) on the current stream.  ``desc`` is
    ``dense_descriptor(cc)``, ``layout_dev`` ``layout.ints`` and
    ``weights`` ``layout.pack(flat)`` (the kernel reads its actor section),
    all on the card.  Returns ``(rewards [T, B], final stock [N, P, B])``."""
    device = _cuda_device(desc)
    lt_ptr = _check_tables(cc, B, device, demands, leadtimes)
    out = launch_policy_lanes(desc, cc, layout, layout_dev, weights, "greedy",
                              cc.T, B, 0, (demands.data_ptr(), lt_ptr, None))
    count("launch.supplychain_greedy")
    return out[4:]


def _setup(cc: CompiledChain, T: int, device):
    """Checks shared by both runner makers -> (device, the kernels' chain
    descriptor ``dense_descriptor(cc)`` on the card or None for the CPU)."""
    if T != cc.T:
        raise ValueError(f"T={T} must equal the chain horizon cc.T={cc.T}")
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    device = resolve_device(device)
    # unsupported chains fail here, when the runner is built
    lane_block(cc, "episode")
    words = dense_descriptor(cc)
    desc = (torch.as_tensor(words, device=device)
            if device.type == "cuda" else None)
    return device, desc


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
    device, desc = _setup(cc, T, device)

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
    device, desc = _setup(cc, T, device)
    layout = MlpLayout(cc.obs_dim, cc.A, hidden)
    if desc is not None:
        policy_block(cc, layout, B, 1)
        layout_dev = torch.as_tensor(layout.ints, device=device)
    # the weights last packed: (the tensors, their version counters, the
    # packed buffer).  An episode of an evaluation sweep reuses the buffer
    # while the same tensors hold the same values; an in-place update (an
    # optimizer step, a load) bumps a tensor's version and packs anew.
    packed = [(), (), None]

    def _packed(flat):
        if any(p.is_inference() for p in flat):     # no version counter
            return layout.pack(flat)
        versions = tuple(p._version for p in flat)
        if (len(flat) != len(packed[0]) or versions != packed[1]
                or any(a is not b for a, b in zip(flat, packed[0]))):
            packed[:] = [tuple(flat), versions, layout.pack(flat)]
        else:
            count("ops.pack_reused")
        return packed[2]

    def run_policy(demands, *rest):
        with span("ops.policy_rollout"):
            dem, lt, params = _tables_of(cc, device, demands, rest)
            flat = flat_params(params)
            for p in flat:
                if p.device != device:
                    raise ValueError(f"params on {p.device}, the runner on "
                                     f"{device}")
            if desc is not None:
                return launch_supplychain_greedy(desc, cc, layout, layout_dev,
                                                 _packed(flat), B, dem, lt)[0]
            return supplychain_episode_plain(cc, B, "policy", dem, lt,
                                             params=flat)[0]

    return run_policy
