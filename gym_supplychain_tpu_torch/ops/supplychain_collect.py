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
  lead-time uniforms (stochastic chains), then R*P demand uniforms.  It is
  ``actions`` fed with the tables ``philox_tables`` makes, so the plain
  version of ``random`` is those tables through the plain ``actions``.
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

The kernels (``csrc/supplychain_collect.cu``) run one thread per env with
its state in per-thread arrays and the chain in a shared-memory descriptor;
the policy kernel runs the MLP cooperatively per block of 32 envs with the
weights in shared memory.  What bounds them on the card, and the float
rules they and the plain version share (no FMA contraction, the pipeline
add association, ordered sums, the stable sorted cut, the MLP's ordered
accumulation), are set out at the top of that file.  The plain version is
an eager loop over ``core/step.py``; the wrapper takes it only for a tensor
on the CPU, and launches the kernel or raises for a CUDA one.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.compile import CompiledChain
from ..core.step import make_supplychain_kernels
from ..models.policy import (LOG_STD_MAX, LOG_STD_MIN, flat_params,
                             split_params, tanh_gaussian_terms)
from ..rng.device import (box_muller, demand_from_uniform,
                          leadtimes_from_uniform, philox_uniform,
                          poisson_clip_thresholds)
from ._mlp import LAYOUT_INTS, SMEM_MAX, MlpLayout

__all__ = ["make_supplychain_collect", "launch_supplychain_collect",
           "launch_supplychain_policy", "supplychain_collect_plain",
           "philox_tables", "chain_descriptor", "policy_smem_bytes",
           "resolve_device", "seed_key"]

_MODES = {"random": 0, "actions": 1, "policy": 2, "policy_eps": 3}
_POLICY_MODES = ("policy", "policy_eps")
_PK_ENVS = 32                      # envs a block of the policy kernel
_MAX = dict(N=32, P=8, NP=32, D=8, ND=256, NPD=256, RING=8, K=64, A=64,
            RP=16, CDF=8)


def _desc_fields():
    """(name, 'i'|'f', count) in the order of ``struct ScChain``."""
    m = _MAX
    NP, N, ND, NPD = m["NP"], m["N"], m["ND"], m["NPD"]
    ints = ("N", "P", "R", "A", "K", "T", "Lavg", "Lmax", "H", "ring", "dmax",
            "obs_dim", "stochastic", "n_cdf", "any_factory", "pad0")
    fields = [(k, "i", 1) for k in ints]
    fields += [(k, "f", 1) for k in ("c_unmet", "c_stock_pen", "c_proc_pen",
                                     "c_ship_pen")]
    fields += [(k, "f", NP) for k in ("init_stock", "stock_cap", "stock_cost",
                                      "supply_cap", "supply_cost", "proc_cost",
                                      "proc_ratio", "ms", "ms_tail")]
    fields += [(k, "i", NP) for k in ("has_supply", "has_ship", "sup_act_idx",
                                      "ms_ok", "cap_finite")]
    fields += [("proc_cap", "f", N)]
    fields += [(k, "i", N) for k in ("is_factory", "lt_base", "node_ships")]
    fields += [("edge_dst", "i", ND), ("edge_mask", "i", ND),
               ("ship_cap_edge", "f", ND), ("ship_cost", "f", NPD),
               ("ship_act_idx", "i", NPD), ("init_pipe", "f", m["RING"] * NP),
               ("retailer_idx", "i", m["RP"])]
    fields += [(k, "f", m["P"]) for k in ("dem_min", "dem_range", "dem_n",
                                          "dem_lo")]
    fields += [("cdf", "f", m["CDF"])]
    return fields


_DESC_FIELDS = _desc_fields()
DESC_BYTES = 4 * sum(c for _, _, c in _DESC_FIELDS)


def _check_uniform_demand(cc: CompiledChain) -> None:
    for cfg in cc.demand:
        if cfg.std is not None or cfg.sen_peaks is not None:
            raise NotImplementedError(
                "collection draws uniform integer demand only; normal and "
                "seasonal demand are not ported yet")


def _check_kernel_support(cc: CompiledChain) -> None:
    """Raise for a chain the kernel does not take."""
    m = _MAX
    sizes = dict(N=cc.N, P=cc.P, NP=cc.N * cc.P, D=cc.Dmax,
                 ND=cc.N * cc.Dmax, NPD=cc.N * cc.P * cc.Dmax, RING=cc.H + 1,
                 K=cc.K, A=cc.A, RP=cc.R * cc.P, CDF=max(cc.Lmax - 1, 0))
    over = {k: v for k, v in sizes.items() if v > m[k]}
    if over:
        raise NotImplementedError(f"chain too large for the collect kernel: "
                                  f"{over} (limits {m})")
    _check_uniform_demand(cc)
    # the kernel's capacity gates assume capacities >= 0
    for name in ("stock_cap", "supply_cap", "proc_cap", "ship_cap_edge"):
        if (np.asarray(getattr(cc, name)) < 0).any():
            raise ValueError(f"negative {name} in the chain")


def chain_descriptor(cc: CompiledChain) -> np.ndarray:
    """The chain as the bytes of ``struct ScChain`` (uint8 array)."""
    _check_kernel_support(cc)
    N, P, D = cc.N, cc.P, cc.Dmax
    NP = N * P
    has_ship = np.asarray(cc.has_ship) & ~np.asarray(cc.is_retailer)[:, None]
    ms = np.where(cc.max_ship > 0, cc.max_ship, 1.0).astype(np.float32)
    ms_tail = ms * np.float32(cc.Lmax - (cc.Lavg - 1))
    cdf = (poisson_clip_thresholds(cc.Lavg - 1, cc.Lmax)
           if cc.stochastic_leadtimes else np.zeros(0, np.float32))
    cfgs = [cc.demand[p if cc.demand_by_product else 0] for p in range(P)]
    vals = dict(
        N=N, P=P, R=cc.R, A=cc.A, K=cc.K, T=cc.T, Lavg=cc.Lavg, Lmax=cc.Lmax,
        H=cc.H, ring=cc.H + 1, dmax=D, obs_dim=cc.obs_dim,
        stochastic=int(cc.stochastic_leadtimes), n_cdf=len(cdf),
        any_factory=int(np.asarray(cc.is_factory).any()), pad0=0,
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
        node_ships=has_ship.any(axis=1), edge_dst=cc.edge_dst,
        edge_mask=cc.edge_mask, ship_cap_edge=cc.ship_cap_edge,
        ship_cost=cc.ship_cost, ship_act_idx=np.maximum(cc.ship_act_idx, 0),
        init_pipe=cc.init_pipe, retailer_idx=cc.retailer_idx,
        dem_min=cc.dem_min, dem_range=cc.dem_range,
        dem_n=[c.maxv - c.minv + 1 for c in cfgs],
        dem_lo=[c.minv for c in cfgs], cdf=cdf)
    words = np.zeros(DESC_BYTES // 4, np.int32)
    off = 0
    for name, kind, count in _DESC_FIELDS:
        v = np.ravel(np.asarray(vals[name]))
        assert v.size <= count, (name, v.size, count)
        if kind == "f":
            words[off:off + v.size] = v.astype(np.float32).view(np.int32)
        else:
            words[off:off + v.size] = v.astype(np.int32)
        off += count
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
                  policy: bool = False):
    """The per-step rows ``random`` mode draws for the global steps
    ``steps``: ``(demands [S,R,P,B] f32, leadtimes [S,K,B] int32 or None,
    actions [S,A,B] f32)``.  With ``policy`` the rows ``policy`` mode draws:
    2A noise uniforms first, so the third table is the normal noise
    ``eps [S,A,B]`` (Box-Muller of uniforms i and A + i)."""
    _check_uniform_demand(cc)
    A, R, P = cc.A, cc.R, cc.P
    Kr = cc.K if cc.stochastic_leadtimes else 0
    n_noise = 2 * A if policy else A
    u = philox_uniform(seed_key(seed), steps, n_noise + Kr + R * P, B, device)
    if policy:
        noise = box_muller(u[:, :A], u[:, A:2 * A])
    else:
        noise = 2.0 * u[:, :A] - 1.0
    leadtimes = None
    if cc.stochastic_leadtimes:
        leadtimes = leadtimes_from_uniform(
            u[:, n_noise:n_noise + Kr],
            poisson_clip_thresholds(cc.Lavg - 1, cc.Lmax))
    ud = u[:, n_noise + Kr:].reshape(u.shape[0], R, P, B)
    demands = torch.stack(
        [demand_from_uniform(ud[:, :, p],
                             cc.demand[p if cc.demand_by_product else 0],
                             0, cc.T, torch.float32) for p in range(P)], dim=2)
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
                              device=None):
    """Plain version: an eager loop over ``core/step.py`` with auto-reset.

    ``actions`` and ``policy_eps`` take S-row tables (``device`` is
    theirs); ``random`` and ``policy`` draw each episode's tables with
    ``philox_tables`` on ``device``.  ``params`` (policy modes) is an
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
                                         B, device, policy=policy)
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
    """Launch the CUDA collect kernel (``random``, ``actions``) on the
    current stream.

    ``desc`` is ``chain_descriptor(cc)`` as a uint8 tensor on the card.
    Returns ``(obs [S,O,B], reward [S,B], final stock [N,P,B])``.
    """
    from ._build import check, library

    if mode not in ("random", "actions"):
        raise ValueError(f"mode {mode!r}: this launcher takes 'random' and "
                         "'actions' (launch_supplychain_policy takes the "
                         "policy modes)")
    device = desc.device
    if device.type != "cuda":
        raise ValueError("the collect kernel runs on a CUDA device")
    _check(desc, "desc", torch.uint8, (DESC_BYTES,), device)
    ptrs = (None, None, None)
    if mode == "actions":
        ptrs = _check_tables(cc, S, B, device, demands, leadtimes, actions,
                             "actions")
    lib = library()
    if lib.sc_chain_bytes() != DESC_BYTES:
        raise RuntimeError("chain descriptor layout differs from the kernel's")
    obs = torch.empty((S, cc.obs_dim, B), dtype=torch.float32, device=device)
    rew = torch.empty((S, B), dtype=torch.float32, device=device)
    stock = torch.empty((cc.N, cc.P, B), dtype=torch.float32, device=device)
    k0, k1 = seed_key(seed)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.sc_collect_launch(
            desc.data_ptr(), DESC_BYTES, _MODES[mode], S, B, *ptrs, k0, k1,
            obs.data_ptr(), rew.data_ptr(), stock.data_ptr(), stream)
    check(code, "supplychain collect")
    launch_supplychain_collect.launches += 1
    return obs, rew, stock


launch_supplychain_collect.launches = 0


def policy_smem_bytes(layout: MlpLayout) -> int:
    """Dynamic shared memory of the policy kernel: the packed weights, the
    obs tile, two hidden-activation tiles and the two head tiles, for a
    block of 32 envs.  Raises where the block would exceed the card's
    shared memory (the chain descriptor and the layout sit beside it)."""
    floats = (layout.wsec[0] + layout.wsec[1]
              + _PK_ENVS * (layout.O + 2 * max(layout.hidden)
                            + sum(layout.head_rows)))
    dyn = 4 * floats
    static = DESC_BYTES + 4 * LAYOUT_INTS
    if dyn + static > SMEM_MAX:
        raise NotImplementedError(
            f"actor-critic O={layout.O}, A={layout.A}, hidden="
            f"{layout.hidden} needs {dyn + static} bytes of shared memory "
            f"per block; the policy kernel has {SMEM_MAX}")
    return dyn


def launch_supplychain_policy(desc: torch.Tensor, cc: CompiledChain,
                              layout: MlpLayout, layout_dev: torch.Tensor,
                              weights: torch.Tensor, S: int, B: int,
                              mode: str, seed: int = 0, demands=None,
                              leadtimes=None, eps=None,
                              sample_major: bool = False):
    """Launch the CUDA policy collect kernel (``policy``, ``policy_eps``)
    on the current stream.

    ``layout_dev`` is ``layout.ints`` and ``weights`` is
    ``layout.pack(flat)``, both on the card.  Returns ``(obs, act_pre,
    logp [S,B], value [S,B], reward [S,B], final stock [N,P,B])`` with obs
    and ``act_pre`` ``[S,X,B]``, or ``[X,S*B]`` with ``sample_major``.
    """
    from ._build import check, library

    if mode not in _POLICY_MODES:
        raise ValueError(f"mode {mode!r}: this launcher takes the policy "
                         "modes")
    device = desc.device
    if device.type != "cuda":
        raise ValueError("the collect kernel runs on a CUDA device")
    if (layout.O, layout.A) != (cc.obs_dim, cc.A):
        raise ValueError(f"actor-critic for O={layout.O}, A={layout.A}; the "
                         f"chain has O={cc.obs_dim}, A={cc.A}")
    _check(desc, "desc", torch.uint8, (DESC_BYTES,), device)
    _check(layout_dev, "layout", torch.int32, (LAYOUT_INTS,), device)
    _check(weights, "weights", torch.float32,
           (layout.wsec[0] + layout.wsec[1],), device)
    smem = policy_smem_bytes(layout)
    ptrs = (None, None, None)
    if mode == "policy_eps":
        ptrs = _check_tables(cc, S, B, device, demands, leadtimes, eps, "eps")
    lib = library()
    if lib.sc_chain_bytes() != DESC_BYTES:
        raise RuntimeError("chain descriptor layout differs from the kernel's")
    if lib.mlp_layout_ints() != LAYOUT_INTS:
        raise RuntimeError("MLP layout differs from the kernel's")
    O, A = cc.obs_dim, cc.A
    f32 = dict(dtype=torch.float32, device=device)
    if sample_major:
        obs = torch.empty((O, S * B), **f32)
        pre = torch.empty((A, S * B), **f32)
    else:
        obs = torch.empty((S, O, B), **f32)
        pre = torch.empty((S, A, B), **f32)
    logp, value, rew = (torch.empty((S, B), **f32) for _ in range(3))
    stock = torch.empty((cc.N, cc.P, B), **f32)
    k0, k1 = seed_key(seed)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.sc_policy_launch(
            desc.data_ptr(), DESC_BYTES, layout_dev.data_ptr(),
            weights.data_ptr(), smem, _MODES[mode], S, B, *ptrs, k0, k1,
            int(sample_major), obs.data_ptr(), pre.data_ptr(),
            logp.data_ptr(), value.data_ptr(), rew.data_ptr(),
            stock.data_ptr(), stream)
    check(code, "supplychain policy collect")
    launch_supplychain_policy.launches += 1
    return obs, pre, logp, value, rew, stock


launch_supplychain_policy.launches = 0


def make_supplychain_collect(cc: CompiledChain, T: int, B: int,
                             mode: str = "random", episodes: int = 1,
                             device="cpu", hidden=None,
                             sample_major: bool = False):
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
    ``[X, S*B]``, else ``[S, X, B]``.

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
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    device = resolve_device(device)
    S = episodes * T
    # unsupported chains and networks fail here, when the collector is built
    desc = (torch.as_tensor(chain_descriptor(cc), device=device)
            if device.type == "cuda" else None)
    if policy:
        layout = MlpLayout(cc.obs_dim, cc.A, hidden)
        if desc is not None:
            policy_smem_bytes(layout)
            layout_dev = torch.as_tensor(layout.ints, device=device)

    def _tensor(x, name, dtype):
        if not isinstance(x, torch.Tensor):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, the collector on "
                             f"{device}")
        return x

    def _run(params=None, **kw):
        if not policy:
            if desc is not None:
                obs, rew, _ = launch_supplychain_collect(desc, cc, S, B, mode,
                                                         **kw)
            else:
                obs, rew, _ = supplychain_collect_plain(cc, episodes, B, mode,
                                                        device=device, **kw)
            return obs, rew
        flat = flat_params(params)
        for p in flat:
            if p.device != device:
                raise ValueError(f"params on {p.device}, the collector on "
                                 f"{device}")
        if desc is not None:
            out = launch_supplychain_policy(
                desc, cc, layout, layout_dev, layout.pack(flat), S, B, mode,
                sample_major=sample_major, **kw)
        else:
            out = supplychain_collect_plain(
                cc, episodes, B, mode, params=flat,
                sample_major=sample_major, device=device, **kw)
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
