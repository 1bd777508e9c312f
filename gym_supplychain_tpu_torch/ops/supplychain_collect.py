"""Supply-chain trajectory collection: CUDA kernels, plain version, wrapper.

Replaces the TPU kernel ``make_supplychain_collect_pallas`` of
``gym_supplychain_tpu/ops/supplychain_pallas.py`` (``_collect_kernel``) in
its four modes.  ``episodes`` back-to-back episodes run in one launch with
auto-reset at every boundary; every step emits its pre-action observation
``obs [S, O, B]`` and its reward ``reward [S, B]`` (S = episodes * T).

* ``actions`` reads per-step tables: demands ``[S, R, P, B]`` f32,
  lead-times ``[S, K, B]`` int32 (stochastic chains only) and actions
  ``[S, A, B]`` f32 in [-1, 1]; table row s feeds step s.
* ``random`` draws those rows in the kernel from Philox4x32-10 keyed by the
  seed at counter ``(lane, step, block, 0)``: A action uniforms, then K
  lead-time uniforms (stochastic chains), then R*P demand uniforms and,
  where a product's demand is normal or has a normal perturbation, R*P
  more (each entry's Box-Muller partner).  Every demand process of the
  reference (uniform integer, normal, seasonal with a normal, a uniform
  integer or no perturbation) is drawn in the kernel, as the JAX kernel's
  ``_demand_from_u`` draws it (``rng/device.py`` ``demand_from_uniforms``).
  It is ``actions`` fed with the tables ``philox_tables`` makes, so the
  plain version of ``random`` is those tables through the plain
  ``actions``.
* ``policy_eps`` runs the sampled tanh-Gaussian actor-critic
  (``models/policy.py``) in the loop: demand and lead-time tables plus a
  normal noise table ``eps [S, A, B]``; the action is ``tanh(mu + std *
  eps)``.  It also emits the pre-tanh action ``act_pre [S, A, B]``, its
  log-prob ``logp [S, B]`` and the critic's ``value [S, B]``.
* ``policy`` draws those rows in the kernel: 2A noise uniforms (Box-Muller
  pairs ``(i, A + i)``), then the lead-time and demand uniforms, at the
  same counters.  It is ``policy_eps`` fed with ``philox_tables(...,
  policy=True)``, and that is its plain version.
* ``sample_major`` (policy modes) writes obs and ``act_pre`` as
  ``[X, S*B]`` with time-major columns ``s*B + b``: the update phase's
  sample layout, read with no copy.

Two kernels serve the modes, both on the lane-group step of
``csrc/supplychain_lanes.cuh`` (the step K5 and K6a share: each env on a
group of 4, 8 or 16 lanes, its state in shared memory), both within the
size limits ``_MAX`` and on the descriptor ``dense_descriptor``
(``ops/supplychain_dense.py``) makes:

* ``random`` and ``actions`` run the lane-group kernel
  (``csrc/supplychain_lanes.cu``), 8 envs a block, launched through
  ``launch_lanes``.
* the policy modes run the policy lane kernel
  (``csrc/supplychain_policy.cu``), launched through
  ``launch_policy_lanes``: E envs a block (``policy_block``), the packed
  weights (``ops/_mlp.py``) in shared memory once a block, the MLP run by
  every thread of the block.

What bounds them on the card, and the MLP's ordered accumulation, are set
out at the top of those files; the float rules the step and the plain
version follow (no FMA contraction, the pipeline add association, ordered
sums, the stable sorted cut), at the top of ``csrc/supplychain_step.cuh``.
The plain version is an eager loop over ``core/step.py``; the wrapper takes
it only for a tensor on the CPU, and launches the kernel or raises for a
CUDA one.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.compile import CompiledChain
from ..core.step import make_supplychain_kernels
from ..models.policy import (LOG_STD_MAX, LOG_STD_MIN, flat_params,
                             split_params, tanh_gaussian_terms)
from ..rng.device import (any_normal_demand, box_muller, demand_constants,
                          demand_from_uniforms, leadtimes_from_uniform,
                          philox_uniform, poisson_clip_thresholds)
from ..utils.profiling import count, span
from ._mlp import MlpLayout

__all__ = ["make_supplychain_collect", "launch_supplychain_collect",
           "launch_supplychain_policy", "supplychain_collect_plain",
           "philox_tables", "chain_descriptor", "check_kernel_support",
           "descriptor_words", "resolve_device", "seed_key"]

_MODES = {"random": 0, "actions": 1, "policy": 2, "policy_eps": 3}
_POLICY_MODES = ("policy", "policy_eps")
_MAX = dict(N=32, P=8, NP=32, D=8, ND=256, NPD=256, RING=8, K=64, A=64,
            RP=16, CDF=8)


def _desc_fields(m=_MAX):
    """(name, 'i'|'f', count) in the order of ``struct ChainT``
    (``csrc/supplychain_step.cuh``) at the size limits ``m``."""
    NP, N, ND, NPD = m["NP"], m["N"], m["ND"], m["NPD"]
    ints = ("N", "P", "R", "A", "K", "T", "Lavg", "Lmax", "H", "ring", "dmax",
            "obs_dim", "stochastic", "n_cdf", "any_factory", "any_normal")
    fields = [(k, "i", 1) for k in ints]
    fields += [(k, "f", 1) for k in ("c_unmet", "c_stock_pen", "c_proc_pen",
                                     "c_ship_pen")]
    fields += [(k, "f", NP) for k in ("init_stock", "stock_cap", "stock_cost",
                                      "supply_cap", "supply_cost", "proc_cost",
                                      "proc_ratio", "ms", "ms_tail")]
    fields += [(k, "i", NP) for k in ("has_supply", "has_ship", "sup_act_idx",
                                      "ms_ok", "cap_finite")]
    fields += [("proc_cap", "f", N)]
    fields += [(k, "i", N) for k in ("is_factory", "lt_base", "node_ships",
                                     "node_deg")]
    fields += [("edge_dst", "i", ND), ("edge_mask", "i", ND),
               ("ship_cap_edge", "f", ND), ("ship_cost", "f", NPD),
               ("ship_act_idx", "i", NPD), ("init_pipe", "f", m["RING"] * NP),
               ("retailer_idx", "i", m["RP"])]
    fields += [(k, "f", m["P"]) for k in ("dem_min", "dem_range", "dem_n",
                                          "dem_lo")]
    fields += [("dem_kind", "i", m["P"])]
    fields += [(k, "f", m["P"]) for k in ("dem_std", "dem_mid", "dem_minv",
                                          "dem_maxv", "dem_minavg",
                                          "dem_half", "dem_peaks")]
    fields += [("cdf", "f", m["CDF"])]
    return fields


_DESC_FIELDS = _desc_fields()
DESC_BYTES = 4 * sum(c for _, _, c in _DESC_FIELDS)


def check_kernel_support(cc: CompiledChain, m=_MAX,
                         kernel: str = "the collect kernel") -> None:
    """Raise for a chain beyond the size limits ``m`` of ``kernel``, or
    with a negative capacity."""
    sizes = dict(N=cc.N, P=cc.P, NP=cc.N * cc.P, D=cc.Dmax,
                 ND=cc.N * cc.Dmax, NPD=cc.N * cc.P * cc.Dmax, RING=cc.H + 1,
                 K=cc.K, A=cc.A, RP=cc.R * cc.P, CDF=max(cc.Lmax - 1, 0))
    over = {k: v for k, v in sizes.items() if v > m[k]}
    if over:
        raise NotImplementedError(f"chain too large for {kernel}: {over} "
                                  f"(limits {m})")
    # the kernels' capacity gates assume capacities >= 0
    for name in ("stock_cap", "supply_cap", "proc_cap", "ship_cap_edge"):
        if (np.asarray(getattr(cc, name)) < 0).any():
            raise ValueError(f"negative {name} in the chain")


def chain_descriptor(cc: CompiledChain) -> np.ndarray:
    """The chain as the bytes of ``ScChain`` (uint8 array): ``ChainT`` at
    the collect kernel's limits ``_MAX``, which it raises beyond."""
    check_kernel_support(cc)
    return descriptor_words(cc, _DESC_FIELDS)


def descriptor_words(cc: CompiledChain, fields) -> np.ndarray:
    """The chain as the bytes of ``struct ChainT`` laid out by ``fields``
    (uint8 array); the caller has checked it against the size limits."""
    N, P, D = cc.N, cc.P, cc.Dmax
    em = np.asarray(cc.edge_mask, bool)
    deg = em.sum(axis=1)
    # a node's degree where its edge slots are a prefix, else all D slots
    prefix = np.array([em[n, :deg[n]].all() for n in range(N)], bool)
    has_ship = np.asarray(cc.has_ship) & ~np.asarray(cc.is_retailer)[:, None]
    ms = np.where(cc.max_ship > 0, cc.max_ship, 1.0).astype(np.float32)
    ms_tail = ms * np.float32(cc.Lmax - (cc.Lavg - 1))
    cdf = (poisson_clip_thresholds(cc.Lavg - 1, cc.Lmax)
           if cc.stochastic_leadtimes else np.zeros(0, np.float32))
    dem = [demand_constants(cc.demand[p if cc.demand_by_product else 0])
           for p in range(P)]
    vals = dict(
        N=N, P=P, R=cc.R, A=cc.A, K=cc.K, T=cc.T, Lavg=cc.Lavg, Lmax=cc.Lmax,
        H=cc.H, ring=cc.H + 1, dmax=D, obs_dim=cc.obs_dim,
        stochastic=int(cc.stochastic_leadtimes), n_cdf=len(cdf),
        any_factory=int(np.asarray(cc.is_factory).any()),
        any_normal=int(any_normal_demand(cc)),
        c_unmet=cc.c_unmet, c_stock_pen=cc.c_stock_pen,
        c_proc_pen=cc.c_proc_pen, c_ship_pen=cc.c_ship_pen,
        init_stock=cc.initial_stock, stock_cap=cc.stock_cap,
        stock_cost=cc.stock_cost, supply_cap=cc.supply_cap,
        supply_cost=cc.supply_cost, proc_cost=cc.proc_cost,
        proc_ratio=cc.proc_ratio, ms=ms, ms_tail=ms_tail,
        has_supply=cc.has_supply, has_ship=has_ship,
        sup_act_idx=np.maximum(cc.sup_act_idx, 0),
        ms_ok=np.asarray(cc.max_ship) > 0,
        cap_finite=np.isfinite(cc.stock_cap),
        proc_cap=cc.proc_cap, is_factory=cc.is_factory, lt_base=cc.lt_base,
        node_ships=has_ship.any(axis=1), node_deg=np.where(prefix, deg, D),
        edge_dst=cc.edge_dst, edge_mask=cc.edge_mask,
        ship_cap_edge=cc.ship_cap_edge, ship_cost=cc.ship_cost,
        ship_act_idx=np.maximum(cc.ship_act_idx, 0), init_pipe=cc.init_pipe,
        retailer_idx=cc.retailer_idx, dem_min=cc.dem_min,
        dem_range=cc.dem_range, cdf=cdf,
        **{"dem_" + k: [c[k] for c in dem] for k in dem[0]})
    words = np.zeros(sum(c for _, _, c in fields), np.int32)
    off = 0
    for name, kind, n in fields:
        v = np.ravel(np.asarray(vals[name]))
        assert v.size <= n, (name, v.size, n)
        if kind == "f":
            words[off:off + v.size] = v.astype(np.float32).view(np.int32)
        else:
            words[off:off + v.size] = v.astype(np.int32)
        off += n
    return words.view(np.uint8)


def resolve_device(device) -> torch.device:
    """``device`` with its index: ``"cuda"`` becomes the current CUDA
    device, so it compares equal to the device of a tensor made there."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def seed_key(seed: int):
    """A seed as the Philox key words ``(low 32 bits, high 32 bits)``."""
    seed = int(seed)
    return seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF


def philox_tables(cc: CompiledChain, seed: int, steps, B: int, device,
                  policy: bool = False, lane0: int = 0):
    """The per-step rows ``random`` mode draws for the global steps
    ``steps``: ``(demands [S,R,P,B] f32, leadtimes [S,K,B] int32 or None,
    actions [S,A,B] f32)``.  With ``policy`` the rows ``policy`` mode draws:
    2A noise uniforms first, so the third table is the normal noise
    ``eps [S,A,B]`` (Box-Muller of uniforms i and A + i).  The demand of
    global step s is drawn at the episode's step ``s % T``, from its R*P
    uniforms and, with a normal demand (``any_normal_demand``), the next
    R*P (``demand_from_uniforms``).  ``lane0`` is the global index of the
    first lane (``philox_words``)."""
    A, R, P = cc.A, cc.R, cc.P
    RP = R * P
    Kr = cc.K if cc.stochastic_leadtimes else 0
    n_noise = 2 * A if policy else A
    n_dem = 2 * RP if any_normal_demand(cc) else RP
    u = philox_uniform(seed_key(seed), steps, n_noise + Kr + n_dem, B, device,
                       lane0)
    S = u.shape[0]
    if policy:
        noise = box_muller(u[:, :A], u[:, A:2 * A])
    else:
        noise = 2.0 * u[:, :A] - 1.0
    leadtimes = None
    if cc.stochastic_leadtimes:
        leadtimes = leadtimes_from_uniform(
            u[:, n_noise:n_noise + Kr],
            poisson_clip_thresholds(cc.Lavg - 1, cc.Lmax))
    ud = u[:, n_noise + Kr:].reshape(S, n_dem // RP, R, P, B)
    te = (torch.as_tensor(steps, dtype=torch.int64, device=u.device)
          % cc.T).to(torch.float32).view(S, 1, 1)
    demands = torch.stack(
        [demand_from_uniforms(ud[:, 0, :, p],
                              ud[:, 1, :, p] if n_dem > RP else None,
                              cc.demand[p if cc.demand_by_product else 0],
                              te, cc.T) for p in range(P)], dim=2)
    return demands, leadtimes, noise


def _mlp_ordered(layers, x):
    """Tanh-MLP with a linear last layer, each product of ``w @ x``
    accumulated over k in order from the k = 0 product, then the bias
    added: the CUDA kernel's order, so the two agree bit for bit."""
    for i, (w, b) in enumerate(layers):
        acc = w[:, 0:1] * x[0:1]
        for k in range(1, w.shape[1]):
            acc = acc + w[:, k:k + 1] * x[k:k + 1]
        x = acc + b
        if i < len(layers) - 1:
            x = torch.tanh(x)
    return x


def _policy_nets(params, device):
    """Actor-critic -> (actor layers with the mu head, critic layers with
    the v head, clipped log_std, std), float32 on ``device``."""
    flat = [p.detach().to(device=device, dtype=torch.float32)
            for p in flat_params(params)]
    actor, mu, critic, v, log_std = split_params(flat)
    log_std = torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)
    return actor + [mu], critic + [v], log_std, torch.exp(log_std)


def _policy_step(nets, obs, eps):
    """One step of the sampled tanh-Gaussian policy, in the kernel's op
    order: ``(pre [A,B], logp [B], value [B], action [A,B])``."""
    actor, critic, log_std, std = nets
    mu = _mlp_ordered(actor, obs)
    value = _mlp_ordered(critic, obs)[0]
    pre = mu + std * eps
    terms = tanh_gaussian_terms(pre, mu, log_std, std)
    logp = terms[0]
    for i in range(1, terms.shape[0]):
        logp = logp + terms[i]
    return pre, logp, value, torch.tanh(pre)


def supplychain_collect_plain(cc: CompiledChain, episodes: int, B: int,
                              mode: str, seed: int = 0, demands=None,
                              leadtimes=None, actions=None, eps=None,
                              params=None, sample_major: bool = False,
                              device=None, lane0: int = 0):
    """Plain version: an eager loop over ``core/step.py`` with auto-reset.

    ``actions`` and ``policy_eps`` take S-row tables (``device`` is
    theirs); ``random`` and ``policy`` draw each episode's tables with
    ``philox_tables`` on ``device``, for the lanes from global index
    ``lane0`` on.  ``params`` (policy modes) is an
    ``ActorCritic`` or its flat list.  Returns ``(obs [S,O,B], reward [S,B],
    final stock [N,P,B])``, and in the policy modes ``(obs, act_pre [S,A,B],
    logp [S,B], value [S,B], reward, final stock)``, obs and ``act_pre`` as
    ``[X, S*B]`` with ``sample_major``.
    """
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    policy = mode in _POLICY_MODES
    if sample_major and not policy:
        raise ValueError("sample_major takes a policy mode")
    T, S = cc.T, episodes * cc.T
    if mode in ("actions", "policy_eps"):
        device = demands.device
    device = torch.device(device)
    reset_fn, step_fn, obs_fn = make_supplychain_kernels(
        cc, dtype=torch.float32, device=device)
    obs = torch.empty((S, cc.obs_dim, B), dtype=torch.float32, device=device)
    rew = torch.empty((S, B), dtype=torch.float32, device=device)
    if policy:
        nets = _policy_nets(params, device)
        pre = torch.empty((S, cc.A, B), dtype=torch.float32, device=device)
        logp = torch.empty((S, B), dtype=torch.float32, device=device)
        value = torch.empty((S, B), dtype=torch.float32, device=device)
    st = None
    for e in range(episodes):
        rows = slice(e * T, (e + 1) * T)
        if mode in ("random", "policy"):
            dem, lt, act = philox_tables(cc, seed, range(e * T, (e + 1) * T),
                                         B, device, policy=policy,
                                         lane0=lane0)
        else:
            dem = demands[rows]
            act = (eps if policy else actions)[rows]
            lt = leadtimes[rows] if cc.stochastic_leadtimes else None
        # row T of an episode's demand table only feeds the terminal obs,
        # which auto-reset replaces
        st = reset_fn(torch.cat([dem, dem[-1:]]), lt, B)
        o = obs_fn(st)
        for te in range(T):
            s = e * T + te
            obs[s] = o
            a = act[te]
            if policy:
                pre[s], logp[s], value[s], a = _policy_step(nets, o, a)
            st, out = step_fn(st, a)
            rew[s] = out.reward
            o = out.obs
    if not policy:
        return obs, rew, st.stock
    if sample_major:
        obs = obs.permute(1, 0, 2).reshape(cc.obs_dim, S * B)
        pre = pre.permute(1, 0, 2).reshape(cc.A, S * B)
    return obs, pre, logp, value, rew, st.stock


def _check(x, name, dtype, shape, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_tables(cc, S, B, device, demands, leadtimes, rows, name):
    _check(demands, "demands", torch.float32, (S, cc.R, cc.P, B), device)
    _check(rows, name, torch.float32, (S, cc.A, B), device)
    if cc.stochastic_leadtimes:
        _check(leadtimes, "leadtimes", torch.int32, (S, cc.K, B), device)
    return (demands.data_ptr(),
            leadtimes.data_ptr() if cc.stochastic_leadtimes else None,
            rows.data_ptr())


def launch_supplychain_collect(desc: torch.Tensor, cc: CompiledChain, S: int,
                               B: int, mode: str, seed: int = 0,
                               demands=None, leadtimes=None, actions=None):
    """Launch the CUDA collect kernel (``random``, ``actions``: the
    lane-group kernel) on the current stream.

    ``desc`` is ``dense_descriptor(cc)`` (``ops/supplychain_dense.py``) as a
    uint8 tensor on the card.  Returns ``(obs [S,O,B], reward [S,B], final
    stock [N,P,B])``.
    """
    # supplychain_dense imports this module
    from .supplychain_dense import launch_lanes

    if mode not in ("random", "actions"):
        raise ValueError(f"mode {mode!r}: this launcher takes 'random' and "
                         "'actions' (launch_supplychain_policy takes the "
                         "policy modes)")
    device = desc.device
    if device.type != "cuda":
        raise ValueError("the collect kernel runs on a CUDA device")
    ptrs = (None, None, None)
    if mode == "actions":
        ptrs = _check_tables(cc, S, B, device, demands, leadtimes, actions,
                             "actions")
    out = launch_lanes(desc, cc, "collect", S, B, mode, seed, ptrs)
    count("launch.supplychain_collect")
    return out


def launch_supplychain_policy(desc: torch.Tensor, cc: CompiledChain,
                              layout: MlpLayout, layout_dev: torch.Tensor,
                              weights: torch.Tensor, S: int, B: int,
                              mode: str, seed: int = 0, demands=None,
                              leadtimes=None, eps=None,
                              sample_major: bool = False, lane0: int = 0):
    """Launch the CUDA policy collect kernel (``policy``, ``policy_eps``:
    the policy lane kernel) on the current stream.

    ``desc`` is ``dense_descriptor(cc)`` (``ops/supplychain_dense.py``),
    ``layout_dev`` is ``layout.ints`` and ``weights`` is
    ``layout.pack(flat)``, all on the card.  Returns ``(obs, act_pre,
    logp [S,B], value [S,B], reward [S,B], final stock [N,P,B])`` with obs
    and ``act_pre`` ``[S,X,B]``, or ``[X,S*B]`` with ``sample_major``.
    ``policy`` draws lane b's rows at the Philox counter of global lane
    ``lane0 + b``.
    """
    # supplychain_dense imports this module
    from .supplychain_dense import launch_policy_lanes

    if mode not in _POLICY_MODES:
        raise ValueError(f"mode {mode!r}: this launcher takes the policy "
                         "modes")
    device = desc.device
    if device.type != "cuda":
        raise ValueError("the collect kernel runs on a CUDA device")
    ptrs = (None, None, None)
    if mode == "policy_eps":
        ptrs = _check_tables(cc, S, B, device, demands, leadtimes, eps, "eps")
    out = launch_policy_lanes(desc, cc, layout, layout_dev, weights, mode, S,
                              B, seed, ptrs, sample_major, lane0)
    count("launch.supplychain_policy")
    return out


def make_supplychain_collect(cc: CompiledChain, T: int, B: int,
                             mode: str = "random", episodes: int = 1,
                             device="cuda", hidden=None,
                             sample_major: bool = False, lane0: int = 0):
    """Trajectory collection over ``episodes`` back-to-back episodes.

    * ``random``: ``run(seed) -> (obs [S,O,B], reward [S,B])``;
    * ``actions``: ``run(demands [S,R,P,B], [leadtimes [S,K,B],]
      actions [S,A,B]) -> (obs, reward)``;
    * ``policy``: ``run(params, seed) -> (obs, act_pre, logp [S,B],
      value [S,B], reward [S,B])``;
    * ``policy_eps``: ``run(demands, [leadtimes,] eps [S,A,B], params)``,
      the same outputs;

    on ``device``.  Numpy tables are put on ``device``, tensors on another
    device are rejected.  ``params`` is an ``ActorCritic`` of widths
    ``hidden`` on ``device``, or its flat list (``_flat_actor_critic``
    order).  ``sample_major`` (policy modes) gives obs and ``act_pre`` as
    ``[X, S*B]``, else ``[S, X, B]``.  ``lane0`` (``policy``) is the
    global index of the first lane: lanes ``lane0 .. lane0 + B - 1`` of a
    larger batch draw what they draw in one process.

    A CUDA device launches the kernel; the CPU runs the plain version.
    """
    if T != cc.T:
        raise ValueError(f"T={T} must equal the chain horizon cc.T={cc.T}")
    if mode not in _MODES:
        raise NotImplementedError(
            f"mode {mode!r}: the modes are {sorted(_MODES)}")
    policy = mode in _POLICY_MODES
    if policy and hidden is None:
        raise ValueError(f"mode {mode!r} needs the actor-critic's hidden "
                         "widths")
    if sample_major and not policy:
        raise ValueError("sample_major takes a policy mode")
    if lane0 and mode != "policy":
        raise ValueError(f"lane0 takes mode 'policy', not {mode!r} (the "
                         "table modes read the lanes' tables as given)")
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    device = resolve_device(device)
    S = episodes * T
    # unsupported chains and networks fail here, when the collector is built
    # (supplychain_dense imports this module)
    from .supplychain_dense import dense_descriptor, lane_block, policy_block
    lane_block(cc, "collect")
    words = dense_descriptor(cc)
    desc = (torch.as_tensor(words, device=device)
            if device.type == "cuda" else None)
    if policy:
        layout = MlpLayout(cc.obs_dim, cc.A, hidden)
        if desc is not None:
            policy_block(cc, layout, B, 2)
            layout_dev = torch.as_tensor(layout.ints, device=device)

    def _tensor(x, name, dtype):
        if not isinstance(x, torch.Tensor):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, the collector on "
                             f"{device}")
        return x

    def _run(params=None, **kw):
        with span("ops.collect"):
            if not policy:
                if desc is not None:
                    obs, rew, _ = launch_supplychain_collect(
                        desc, cc, S, B, mode, **kw)
                else:
                    obs, rew, _ = supplychain_collect_plain(
                        cc, episodes, B, mode, device=device, **kw)
                return obs, rew
            flat = flat_params(params)
            for p in flat:
                if p.device != device:
                    raise ValueError(f"params on {p.device}, the collector on "
                                     f"{device}")
            if desc is not None:
                out = launch_supplychain_policy(
                    desc, cc, layout, layout_dev, layout.pack(flat), S, B,
                    mode, sample_major=sample_major, lane0=lane0, **kw)
            else:
                out = supplychain_collect_plain(
                    cc, episodes, B, mode, params=flat,
                    sample_major=sample_major, device=device, lane0=lane0,
                    **kw)
            return out[:5]

    if mode == "random":
        return lambda seed: _run(seed=seed)
    if mode == "policy":
        return lambda params, seed: _run(params, seed=seed)

    def _tables(demands, rest):
        if cc.stochastic_leadtimes:
            leadtimes, rows = rest
            leadtimes = _tensor(leadtimes, "leadtimes", torch.int32)
        else:
            (rows,), leadtimes = rest, None
        return _tensor(demands, "demands", torch.float32), leadtimes, rows

    if mode == "actions":
        def run(demands, *rest):
            dem, lt, act = _tables(demands, rest)
            return _run(demands=dem, leadtimes=lt,
                        actions=_tensor(act, "actions", torch.float32))
        return run

    def run_eps(demands, *rest):
        *rest, params = rest
        dem, lt, eps = _tables(demands, rest)
        return _run(params, demands=dem, leadtimes=lt,
                    eps=_tensor(eps, "eps", torch.float32))
    return run_eps
