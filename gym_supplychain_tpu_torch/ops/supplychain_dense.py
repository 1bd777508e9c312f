"""The lane-group kernels' descriptor, planners and launches, and the
trajectory collection for large chains (K5): CUDA kernel, plain version,
wrapper.

The lane-group kernel (``csrc/supplychain_lanes.cuh``) steps each env on a
group of G lanes, E envs a block, with the env's state in shared memory:
lanes split each phase of the step over nodes, rows or shipping nodes, and
the lane of each destination adds its incoming edges' shipments in the
order ``dense_edges`` lists them.  It reads each input where the step uses
it.  It serves three kernels, all on the descriptor ``dense_descriptor``
makes and planned by ``lane_block``: K5 here, K1's ``random`` and
``actions`` modes (``ops/supplychain_collect.py``) and K6a
(``ops/supplychain_episode.py``), each launched through ``launch_lanes``.
The policy lane kernel (``csrc/supplychain_policy.cu``) runs the same step
with the actor in the loop, the MLP over every thread of a block: K1's
policy modes and K4, planned by ``policy_block`` and launched through
``launch_policy_lanes``.
They follow the collect kernels' float rules (``csrc/supplychain_step.cuh``)
and matches the plain versions bit for bit in the dynamics; rewards differ
in the order of the cost sum (~1e-7 relative).

K5 replaces the TPU kernel ``make_supplychain_dense_collect_pallas`` of
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
  chains), then R*P demand uniforms (and R*P Box-Muller partners with a
  normal demand), every demand process drawn in the kernel.  It is
  ``actions`` fed the tables ``philox_tables`` makes, and that is its plain
  version.  The JAX dense kernel draws lead-times per use from the TPU's
  generator instead; no stream of the port matches the TPU's value for
  value anyway.

K5 runs 16 lanes an env, 8 envs a block, and builds none of the JAX
kernel's pre-gathered ``[S, N, P, Dmax, B]`` tables.  Its plain version is
an eager loop over ``core/step.py`` (``supplychain_collect_plain``).  The
wrapper takes the plain version only for a tensor on the CPU, and launches
the kernel or raises for a CUDA one.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.compile import CompiledChain
from ..utils.profiling import count
from ._mlp import LAYOUT_INTS, SMEM_MAX, MlpLayout
from .supplychain_collect import (_MAX, _check, _check_tables, _desc_fields,
                                  check_kernel_support, descriptor_words,
                                  resolve_device, seed_key,
                                  supplychain_collect_plain)

__all__ = ["make_supplychain_dense_collect", "launch_supplychain_dense",
           "supplychain_dense_collect_plain", "dense_descriptor",
           "dense_edges", "lane_block", "launch_lanes", "policy_block",
           "launch_policy_lanes", "DENSE_MAX"]

_MODES = ("random", "actions")            # K5's modes
_LANE_MODES = {"random": 0, "actions": 1, "seeded": 4}  # the kernel's numbers
# the kernel's size limits (DN_MAX_* of csrc/supplychain_lanes.cuh; K and A
# bound nothing in the kernel, they are its tested range)
DENSE_MAX = dict(N=64, P=16, NP=128, D=16, ND=1024, NPD=2048, RING=8, K=512,
                 A=1024, RP=128, CDF=8)
_DN_FIELDS = _desc_fields(DENSE_MAX)
# struct DnEdges of csrc/supplychain_lanes.cuh, right after DnChain
_DN_EDGE_FIELDS = [("n_edges", "i", 1), ("n_ship", "i", 1), ("pad0", "i", 1),
                   ("pad1", "i", 1), ("ship_list", "i", DENSE_MAX["N"]),
                   ("edge_id", "i", DENSE_MAX["ND"]),
                   ("in_ptr", "i", DENSE_MAX["N"] + 1),
                   ("in_edge", "i", DENSE_MAX["ND"])]
DN_CHAIN_BYTES = 4 * sum(c for _, _, c in _DN_FIELDS)
DN_DESC_BYTES = DN_CHAIN_BYTES + 4 * sum(c for _, _, c in _DN_EDGE_FIELDS)
_SLOT_BOUNDS = (2, 4, 10, 16)  # the kernel's compile-time degrees (LN_CASE)
# lanes an env of K1 and K6a (the least that holds max(N*P, shipping
# nodes)), and envs a block of every instance (LN_CASE in csrc/)
LANE_GROUPS, LANE_ENVS = (4, 8, 16), 8
# each kind's launch entry (K5, K1, K6a)
_ENTRIES = {"dense": "sc_dense_launch", "collect": "sc_lane_launch",
            "episode": "sc_episode_launch"}
# envs a block of the policy lane kernel, largest first, the blocks its E
# must still make (about one an SM of the H100's 132) and its threads a
# block at most (PL_MAX_THREADS of csrc/supplychain_policy.cu)
POLICY_ENVS, POLICY_MIN_BLOCKS, POLICY_MAX_THREADS = (32, 16, 8), 128, 256
# the policy lane kernel's modes (MODE_* of csrc/supplychain_step.cuh)
_POLICY_MODES = {"policy": 2, "policy_eps": 3, "greedy": 5}


def dense_slot_bound(cc: CompiledChain) -> int:
    """The kernel instance's compile-time slot count: the least of
    ``_SLOT_BOUNDS`` that holds ``Dmax`` (its slot loops unroll into
    registers)."""
    return next(d for d in _SLOT_BOUNDS if cc.Dmax <= d)


def _shipping_nodes(cc: CompiledChain) -> np.ndarray:
    """Which nodes ship: a non-retailer with a product to ship."""
    return (np.asarray(cc.has_ship)
            & ~np.asarray(cc.is_retailer)[:, None]).any(axis=1)


def dense_edges(cc: CompiledChain) -> dict:
    """The edges as the kernel's lanes walk them (``struct DnEdges``).

    Edges are the ``(node, slot)`` pairs of shipping nodes (a non-retailer
    with a product to ship) whose ``edge_mask`` is set, numbered in
    ``(node, slot)`` order: ``edge_id[n * Dmax + d]`` (-1 for none).
    ``in_edge[in_ptr[m]:in_ptr[m + 1]]`` lists node m's incoming edges in
    that order, the order ``core/step.py`` sums a destination's pushes in;
    ``ship_list`` holds the shipping nodes."""
    N, D = cc.N, cc.Dmax
    em = np.asarray(cc.edge_mask, bool)
    has_ship = _shipping_nodes(cc)
    edge_id = np.full(N * D, -1, np.int32)
    src = []
    for n in range(N):
        for d in range(D):
            if has_ship[n] and em[n, d]:
                edge_id[n * D + d] = len(src)
                src.append((n, d))
    dst = [int(cc.edge_dst[n, d]) for n, d in src]
    in_edge = np.array(sorted(range(len(src)), key=lambda e: (dst[e], e)),
                       np.int32)
    in_ptr = np.searchsorted(np.array(sorted(dst), np.int64),
                             np.arange(N + 1)).astype(np.int32)
    return dict(n_edges=len(src), n_ship=int(has_ship.sum()),
                ship_list=np.nonzero(has_ship)[0].astype(np.int32),
                edge_id=edge_id, in_ptr=in_ptr, in_edge=in_edge)


def dense_descriptor(cc: CompiledChain) -> np.ndarray:
    """The chain as the bytes of ``DnChain`` then ``DnEdges`` (uint8
    array); raises for a chain beyond ``DENSE_MAX`` or with a negative
    capacity."""
    check_kernel_support(cc, DENSE_MAX, "the dense collect kernel")
    edges = dense_edges(cc)
    words = np.zeros(DN_DESC_BYTES // 4, np.int32)
    words[:DN_CHAIN_BYTES // 4] = descriptor_words(cc, _DN_FIELDS).view(
        np.int32)
    off = DN_CHAIN_BYTES // 4
    for name, _, count in _DN_EDGE_FIELDS:
        v = np.ravel(edges.get(name, 0))
        words[off:off + v.size] = v
        off += count
    return words.view(np.uint8)


def _stretch_words(cc: CompiledChain, obs: bool) -> int:
    """Words of an env's stretch (``lane_block``), with or without its
    observation."""
    ships = _shipping_nodes(cc)
    # dense_edges' counts, without its lists: the launches plan every call
    n_edges = int((np.asarray(cc.edge_mask, bool) & ships[:, None]).sum())
    NP = cc.N * cc.P
    return (NP * (1 + cc.H + 1) + cc.R * cc.P + n_edges * (cc.P + 1) + cc.N
            + (cc.obs_dim if obs else 0))


def _small_lanes(cc: CompiledChain) -> int:
    """Lanes an env on a chain within the collect kernel's limits: the
    least of ``LANE_GROUPS`` that holds max(N*P, shipping nodes)."""
    need = max(cc.N * cc.P, int(_shipping_nodes(cc).sum()))
    return next((g for g in LANE_GROUPS if g >= need), LANE_GROUPS[-1])


def lane_block(cc: CompiledChain, kind: str):
    """``(G, E, stride, shared bytes)`` of the lane-group kernel for
    ``kind``: ``"dense"`` (K5: 16 lanes an env), ``"collect"`` (K1
    ``random``/``actions``) or ``"episode"`` (K6a: no observation); the
    last two take the least of ``LANE_GROUPS`` that holds ``max(N*P,
    shipping nodes)`` and only chains within the collect kernel's limits.
    E is ``LANE_ENVS``: a block's o-major obs write-out runs are one 32-byte
    sector.  Each env has an odd-length stretch of ``stride`` words (so the
    write-out reads the block's envs from distinct banks): stock ``[N*P]``,
    the pipeline ring ``[RING*N*P]``, the demand row ``[R*P]``, the shipped
    amount per (edge, product) and lead-time per edge, the fired count per
    node and, but in ``"episode"``, the observation ``[O]``.  Raises for a
    chain beyond the kind's limits or where E envs do not fit in a block."""
    if kind not in _ENTRIES:
        raise ValueError(f"unknown lane-kernel kind {kind!r}")
    if kind != "dense":
        check_kernel_support(cc, _MAX)
    G = 16 if kind == "dense" else _small_lanes(cc)
    E, stride = LANE_ENVS, _stretch_words(cc, kind != "episode") | 1
    smem = 4 * E * stride
    if smem > SMEM_MAX:
        raise NotImplementedError(f"{E} envs of this chain take {smem} bytes "
                                  f"of shared memory; a block has {SMEM_MAX}")
    return G, E, stride, smem


def policy_block(cc: CompiledChain, layout: MlpLayout, B: int, nets: int):
    """``(G, E, stride, shared bytes)`` of the policy lane kernel
    (``csrc/supplychain_policy.cu``) for ``nets`` networks: 2 for K1's
    policy modes (actor and critic), 1 for K4 (the actor).

    G is ``lane_block``'s for the chain (4 lanes linear, 8 ntom).  The
    weights are copied once a block, so E, the envs a block, is the largest
    of ``POLICY_ENVS`` that still makes ``POLICY_MIN_BLOCKS`` blocks of B
    envs (B = 4096: 32; B = 1024: 8), else the smallest, within
    ``POLICY_MAX_THREADS`` threads a block (16 lanes: 16 envs).  A block's
    dynamic shared memory holds the packed weights of its nets, two hidden
    tiles ``[Hmax, E]``, the heads ``[Jp, E]`` and E env stretches of
    ``stride`` words (odd): ``lane_block``'s ``"collect"`` stretch and the
    step's action ``[A]``.  Raises ``NotImplementedError`` where that and the
    layout ints exceed a block's shared memory, and for a chain beyond the
    collect kernel's limits."""
    if nets not in (1, 2):
        raise ValueError(f"nets must be 1 or 2, got {nets}")
    if (layout.O, layout.A) != (cc.obs_dim, cc.A):
        raise ValueError(f"actor-critic for O={layout.O}, A={layout.A}; the "
                         f"chain has O={cc.obs_dim}, A={cc.A}")
    check_kernel_support(cc, _MAX)
    G = _small_lanes(cc)
    stride = (_stretch_words(cc, True) + cc.A) | 1
    fits = [e for e in POLICY_ENVS if G * e <= POLICY_MAX_THREADS]
    E = next((e for e in fits if -(-B // e) >= POLICY_MIN_BLOCKS), fits[-1])
    floats = sum(layout.wsec[:nets]) + E * (
        2 * max(layout.hidden) + sum(layout.head_rows[:nets]) + stride)
    smem = 4 * floats
    total = smem + 4 * LAYOUT_INTS
    if total > SMEM_MAX:
        raise NotImplementedError(
            f"{'actor-critic' if nets == 2 else 'actor'} O={layout.O}, "
            f"A={layout.A}, hidden={layout.hidden} at {E} envs a block needs "
            f"{total} bytes of shared memory, {total - SMEM_MAX} beyond the "
            f"{SMEM_MAX} a block has")
    return G, E, stride, smem


def launch_lanes(desc: torch.Tensor, cc: CompiledChain, kind: str, S: int,
                 B: int, mode: str, seed: int, ptrs):
    """Launch the lane-group kernel planned by ``lane_block(cc, kind)`` on
    the current stream, S steps (auto-reset every T).  ``desc`` is
    ``dense_descriptor(cc)`` on the card, ``ptrs`` the addresses of the
    demand, lead-time and action tables the caller checked (None where the
    mode draws them).  Returns ``(obs [S,O,B], reward [S,B], final stock
    [N,P,B])``, obs None for ``"episode"``."""
    from ._build import check, library

    device = desc.device
    if device.type != "cuda":
        raise ValueError("the lane-group kernel runs on a CUDA device")
    _check(desc, "desc", torch.uint8, (DN_DESC_BYTES,), device)
    G, E, stride, smem = lane_block(cc, kind)
    lib = library()
    if lib.dn_chain_bytes() + lib.dn_edges_bytes() != DN_DESC_BYTES:
        raise RuntimeError("chain descriptor layout differs from the kernel's")
    f32 = dict(dtype=torch.float32, device=device)
    obs = (torch.empty((S, cc.obs_dim, B), **f32) if kind != "episode"
           else None)
    rew = torch.empty((S, B), **f32)
    stock = torch.empty((cc.N, cc.P, B), **f32)
    entry = getattr(lib, _ENTRIES[kind])
    k0, k1 = seed_key(seed)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = entry(desc.data_ptr(), DN_DESC_BYTES, _LANE_MODES[mode], S, B,
                     G, E, dense_slot_bound(cc), int(obs is not None), stride,
                     smem, *ptrs, k0, k1,
                     obs.data_ptr() if obs is not None else None,
                     rew.data_ptr(), stock.data_ptr(), stream)
    check(code, f"lane-group kernel ({kind}, {G} lanes, {E} envs a block)")
    return obs, rew, stock


def launch_policy_lanes(desc: torch.Tensor, cc: CompiledChain,
                        layout: MlpLayout, layout_dev: torch.Tensor,
                        weights: torch.Tensor, mode: str, S: int, B: int,
                        seed: int, ptrs, sample_major: bool = False,
                        lane0: int = 0):
    """Launch the policy lane kernel planned by ``policy_block`` on the
    current stream, S steps (auto-reset every T): ``mode`` ``"policy"`` or
    ``"policy_eps"`` (K1: actor and critic) or ``"greedy"`` (K4: the actor,
    one episode).  ``desc`` is ``dense_descriptor(cc)``, ``layout_dev``
    ``layout.ints`` and ``weights`` ``layout.pack(flat)``, all on the card;
    ``ptrs`` the addresses of the demand, lead-time and noise tables the
    caller checked (None where the mode draws them); ``policy`` draws lane
    b's rows at the counter of global lane ``lane0 + b``.  Returns ``(obs,
    act_pre, logp [S,B], value [S,B], reward [S,B], final stock [N,P,B])``
    with obs and ``act_pre`` ``[S,X,B]``, or ``[X,S*B]`` with
    ``sample_major``; K4 returns only the reward and the stock (the rest
    None)."""
    from ._build import check, library

    device = desc.device
    if device.type != "cuda":
        raise ValueError("the policy lane kernel runs on a CUDA device")
    _check(desc, "desc", torch.uint8, (DN_DESC_BYTES,), device)
    _check(layout_dev, "layout", torch.int32, (LAYOUT_INTS,), device)
    _check(weights, "weights", torch.float32,
           (layout.wsec[0] + layout.wsec[1],), device)
    greedy = mode == "greedy"
    G, E, stride, smem = policy_block(cc, layout, B, 1 if greedy else 2)
    lib = library()
    if lib.dn_chain_bytes() + lib.dn_edges_bytes() != DN_DESC_BYTES:
        raise RuntimeError("chain descriptor layout differs from the kernel's")
    if lib.mlp_layout_ints() != LAYOUT_INTS:
        raise RuntimeError("MLP layout differs from the kernel's")
    f32 = dict(dtype=torch.float32, device=device)
    O, A = cc.obs_dim, cc.A
    obs = pre = logp = value = None
    if not greedy:
        obs = torch.empty((O, S * B) if sample_major else (S, O, B), **f32)
        pre = torch.empty((A, S * B) if sample_major else (S, A, B), **f32)
        logp, value = torch.empty((S, B), **f32), torch.empty((S, B), **f32)
    rew = torch.empty((S, B), **f32)
    stock = torch.empty((cc.N, cc.P, B), **f32)
    k0, k1 = seed_key(seed)
    ptr = (lambda x: None if x is None else x.data_ptr())  # noqa: E731
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.sc_policy_lane_launch(
            desc.data_ptr(), DN_DESC_BYTES, layout_dev.data_ptr(),
            weights.data_ptr(), _POLICY_MODES[mode], S, B, G, E,
            dense_slot_bound(cc), stride, smem, *ptrs, k0, k1,
            int(lane0) & 0xFFFFFFFF, int(sample_major), ptr(obs), ptr(pre),
            ptr(logp), ptr(value),
            rew.data_ptr(), stock.data_ptr(), stream)
    check(code, f"policy lane kernel ({mode}, {G} lanes, {E} envs a block)")
    return obs, pre, logp, value, rew, stock


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
    """Launch the CUDA dense collect kernel (the lane-group kernel at 16
    lanes an env) on the current stream.

    ``desc`` is ``dense_descriptor(cc)`` as a uint8 tensor on the card.
    Returns ``(obs [S,O,B], reward [S,B], final stock [N,P,B])``.
    """
    if mode not in _MODES:
        raise ValueError(f"unknown dense collect mode {mode!r}")
    device = desc.device
    if device.type != "cuda":
        raise ValueError("the dense collect kernel runs on a CUDA device")
    ptrs = (None, None, None)
    if mode == "actions":
        ptrs = _check_tables(cc, S, B, device, demands, leadtimes, actions,
                             "actions")
    out = launch_lanes(desc, cc, "dense", S, B, mode, seed, ptrs)
    count("launch.supplychain_dense")
    return out


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
    lane_block(cc, "dense")
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
