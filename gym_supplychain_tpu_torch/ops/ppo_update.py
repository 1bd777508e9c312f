"""Fused clipped-PPO update: CUDA kernel, plain version, autograd wrapper.

Replaces the TPU kernel ``make_ppo_update_grads`` of
``gym_supplychain_tpu/ops/ppo_update_pallas.py`` (``_kernel``): the
actor-critic forward, the clipped-PPO loss of ``learn/ppo.py``'s
``_make_cont_loss`` and its hand-derived backward over M samples, giving
the scalar loss and the gradient of every parameter.  Data is
sample-trailing (``obs [O, M]``, ``pre [A, M]``, ``old_logp``, ``adv``,
``ret [M]``; advantages already normalized), float32.  With
``compute_dtype=torch.bfloat16`` every product takes bf16 operands where
the TPU kernel's ``_c`` rounds them (trunks, heads, input and weight
gradients), with float32 accumulation and float32 loss math.

The kernel (``csrc/ppo_update.cu``) splits the actor and the critic over
two rows of 512-thread blocks, walks 64-sample tiles with the weights and
the tile's activations in shared memory and the gradient accumulators in
registers (4x4 blocks a thread, ``ppo_update_slots``), prefetches the next
tile with cp.async, writes per-block partial gradients and sums them in a
fixed order, so two launches on the same inputs give the
same gradients.  Its plain version is autograd of the PyTorch loss.
The bf16 mode is a second kernel (``csrc/ppo_update_bf16.cuh``) whose
products run on Hopper's warpgroup tensor cores (``wgmma`` m64nNk16, bf16
operands from swizzled shared memory, float32 accumulation): two
warpgroups a block, each carrying 64 samples of a 128-sample tile through
the forward, the loss and the input gradients, meeting for the weight
gradients; it reads the same float32 weights and rounds them itself
(``ppo_update_bf16_plan``).  The nets none of its instances takes run
on a third kernel (``csrc/ppo_update_bf16_mma.cu``): the float32 kernel's
512-thread blocks and 64-sample tiles with every product on ``mma.sync``
through ``ldmatrix``, the weights rounded to bf16 as a block stages them.
Both take the same launch entry; the plan names the kernel by the net's
shape alone.  Their plain version is autograd of the loss over
``kernel_forward``, each product's operands and incoming gradient rounded
to bf16.
``PPOLossFn`` wraps either as a ``torch.autograd.Function``: its forward
computes the loss and the gradients at once and its backward hands the
gradients back, so an update loop calls ``loss.backward()`` whichever ran.
"""
from __future__ import annotations

import ctypes

import torch

from ..models.policy import (LOG_STD_MAX, LOG_STD_MIN, flat_params,
                             split_params)
from ..utils.profiling import count, span
from ._mlp import LAYOUT_INTS, SMEM_MAX, MlpLayout

__all__ = ["make_ppo_update_grads", "launch_ppo_update",
           "launch_ppo_update_bf16", "launch_ppo_update_bf16_mma",
           "ppo_update_plain", "kernel_forward", "ppo_update_smem_bytes",
           "ppo_update_slots", "ppo_update_bf16_plan",
           "ppo_update_bf16_mma_tiles", "ppo_update_bf16_mma_smem_bytes",
           "PPOLossFn", "fused_ppo_loss"]

_THREADS = 512             # threads a block (PU_THREADS)
_TS, _LD = 64, 68          # samples a tile, row stride of the tile buffers
_MAXQ, _MAXB = 3, 2        # gradient register slots a thread (PU_MAXQ, PU_MAXB)
_STATIC = 4 * (LAYOUT_INTS + 2 * _TS)   # static shared memory
_MAX_BLOCKS = 66           # blocks per net: 2 * 66 fill the H100's 132 SMs
_BF16_THREADS = 256        # threads a bf16 block: two warpgroups (PB_THREADS)
_BF16_TS = 128             # samples a bf16 tile, 64 a warpgroup (PB_TS)
# the bf16 kernel's instances: (H, obs rows KP, head rows HA) -> hidden
# layers (csrc/ppo_update_bf16*.cu)
_BF16_INSTANCES = {(128, 32, 16): (1, 2), (64, 32, 16): (1, 2, 3, 4),
                   (128, 64, 32): (1,), (64, 64, 32): (1, 2, 3)}
# the bf16 mode's mma.sync kernel (csrc/ppo_update_bf16_mma.cu): 16x8
# weight-gradient tiles a warp (PM_MAXQ), row stride of its bf16 tiles
_MMA_MAXQ, _MMA_LDB = 12, 72
_WARPS = _THREADS // 32


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def ppo_update_slots(layout: MlpLayout):
    """Register slots of the update kernel's weight-gradient blocks, per net
    (actor, critic): the 4x4 blocks of every layer's ``dW`` (``ceil(J/4) *
    ceil(K/4)`` a layer), numbered layer after layer, go round-robin over
    the block's threads, so a thread holds ``ceil(blocks / threads)``.
    Raises where a net needs more slots than a thread holds, or more biases
    than its bias slots cover."""
    out = []
    for net, rows in enumerate(layout.layers):
        blocks = sum(-(-J // 4) * -(-K // 4) for K, J, *_ in rows)
        slots = -(-blocks // _THREADS)
        biases = sum(J for _, J, *_ in rows)
        if slots > _MAXQ or biases > _MAXB * _THREADS:
            raise NotImplementedError(
                f"actor-critic O={layout.O}, A={layout.A}, hidden="
                f"{layout.hidden}: the {('actor', 'critic')[net]}'s gradient "
                f"needs {slots} register slots and {biases} bias slots a "
                f"block; the update kernel holds {_MAXQ} and "
                f"{_MAXB * _THREADS}")
        out.append(slots)
    return tuple(out)


def ppo_update_smem_bytes(layout: MlpLayout) -> int:
    """Dynamic shared memory of the update kernel's larger block: its net's
    packed weights, then ``[rows][68]`` tile buffers: each hidden layer's
    activations, the head, the actor's z and log-prob terms, and two input
    slots (obs padded to 8 rows, pre, old_logp, adv, ret) for the cp.async
    prefetch.  Raises where a block would exceed the card's shared memory
    or a thread's gradient registers (``ppo_update_slots``)."""
    ppo_update_slots(layout)
    slot_rows = _pad8(layout.O) + layout.A + 3
    sizes = []
    for net in (0, 1):
        rows = (sum(_pad8(h) for h in layout.hidden) + layout.head_rows[net]
                + 2 * _pad8(layout.A) + 2 * slot_rows)
        sizes.append(4 * (layout.wsec[net] + rows * _LD))
    dyn = max(sizes)
    if dyn + _STATIC > SMEM_MAX:
        raise NotImplementedError(
            f"actor-critic O={layout.O}, A={layout.A}, hidden="
            f"{layout.hidden} needs {dyn + _STATIC} bytes of shared memory "
            f"per block; the update kernel has {SMEM_MAX}")
    return dyn


def ppo_update_bf16_mma_tiles(layout: MlpLayout):
    """16x8 weight-gradient tiles of the bf16 mode's mma.sync kernel, per
    net (actor, critic): ``ceil(J/16) * ceil(K/8)`` a layer, dealt
    round-robin over the block's 16 warps.  Raises where a warp would hold
    more than its register slots, or a net more biases than its bias slots
    cover."""
    out = []
    for net, rows in enumerate(layout.layers):
        tiles = sum(-(-J // 16) * -(-K // 8) for K, J, *_ in rows)
        biases = sum(J for _, J, *_ in rows)
        if -(-tiles // _WARPS) > _MMA_MAXQ or biases > _MAXB * _THREADS:
            raise NotImplementedError(
                f"actor-critic O={layout.O}, A={layout.A}, hidden="
                f"{layout.hidden}: the {('actor', 'critic')[net]}'s gradient "
                f"needs {tiles} tiles and {biases} bias slots a block; the "
                f"bf16 update kernel takes {_MMA_MAXQ * _WARPS} and "
                f"{_MAXB * _THREADS}")
        out.append(tiles)
    return tuple(out)


def _mma_section_words(layout: MlpLayout):
    """Words of each net's section in the mma.sync kernel's shared memory
    (``pm_section``): every layer's w as bf16 ``[pad16(J)][pad16(K) + 8]``,
    the float32 biases (``pad16(J)`` each), the actor's log_std
    (``pad8(A)``), padded to 4 words."""
    out = []
    for net, rows in enumerate(layout.layers):
        w_el = sum(_pad16(J) * (_pad16(K) + 8) for K, J, *_ in rows)
        words = w_el // 2 + sum(_pad16(J) for _, J, *_ in rows)
        if net == 0:
            words += _pad8(layout.A)
        out.append(-(-words // 4) * 4)
    return out


def ppo_update_bf16_mma_smem_bytes(layout: MlpLayout) -> int:
    """Dynamic shared memory of the mma.sync kernel's larger block: its
    net's section (``_mma_section_words``), the bf16 tiles
    ``[pad16(rows)][72]`` of the obs and each hidden layer's output, their
    float32 copies ``[pad16(rows)][68]``, the head's output (float32) and
    gradient (bf16), z and the log-prob terms, and two input slots.  Raises
    where a block would exceed the card's shared memory or a warp's
    gradient registers (``ppo_update_bf16_mma_tiles``)."""
    ppo_update_bf16_mma_tiles(layout)
    slot_rows = _pad8(layout.O) + layout.A + 3
    widths = [_pad16(h) for h in layout.hidden]
    sizes = []
    for net, words in enumerate(_mma_section_words(layout)):
        head = _pad16(layout.layers[net][-1][1])
        sizes.append(4 * words
                     + 2 * _MMA_LDB * (_pad16(layout.O) + sum(widths) + head)
                     + 4 * _LD * (sum(widths) + head + 2 * _pad8(layout.A)
                                  + 2 * slot_rows))
    dyn = max(sizes)
    if dyn + _STATIC > SMEM_MAX:
        raise NotImplementedError(
            f"actor-critic O={layout.O}, A={layout.A}, hidden="
            f"{layout.hidden} needs {dyn + _STATIC} bytes of shared memory "
            f"per block; the bf16 update kernel takes {SMEM_MAX}")
    return dyn


def ppo_update_bf16_plan(layout: MlpLayout) -> dict:
    """The bf16 mode's kernel for ``layout``, chosen by the net's shape
    alone.  The wgmma kernel where one of its instances holds the net
    (``kernel="wgmma"``): every hidden layer padded to ``H`` = 64 or 128
    units (``layers`` of them), the obs to ``KP`` = 32 or 64 rows and the
    heads to ``HA`` = 16 or 32 (``_BF16_INSTANCES``); its shared memory is
    the library's (``ppo_bf16_smem_bytes``).  Else the mma.sync kernel
    (``kernel="mma"``) where its weight-gradient tiles and shared memory
    (``smem``) fit.  Raises where neither takes the net."""
    O, A, hidden = layout.O, layout.A, tuple(layout.hidden)
    NL = len(hidden)            # 1 to 4: MlpLayout refuses the rest
    H = 64 if max(hidden) <= 64 else 128
    KP, HA = (32, 16) if O <= 32 and A <= 16 else (64, 32)
    if (max(hidden) <= 128 and O <= 64 and A <= 32
            and NL in _BF16_INSTANCES[(H, KP, HA)]):
        return dict(kernel="wgmma", H=H, layers=NL, KP=KP, HA=HA)
    try:
        smem = ppo_update_bf16_mma_smem_bytes(layout)
    except NotImplementedError as e:
        raise NotImplementedError(
            f"actor-critic O={O}, A={A}, hidden={hidden}: no wgmma instance "
            "holds it (the wgmma instances take O <= 32 and A <= 16 with "
            "1-4 hidden layers of at most 64 units or 1-2 of at most 128, "
            "and O <= 64 and A <= 32 with 1-3 of at most 64 or 1 of at most "
            f"128), and {e}") from None
    return dict(kernel="mma", smem=smem)


def _rounded(x, dtype):
    return x.to(dtype).to(x.dtype)


class _RoundedMatmul(torch.autograd.Function):
    """``a @ b`` with both operands rounded to ``dtype`` and the product in
    their own dtype (exact for bf16 operands in float32); the backward
    rounds the incoming gradient and uses the rounded operands, as the
    update kernel's bf16 products do (the TPU kernel's ``_dot_nt`` and
    ``_dot_tn``)."""

    @staticmethod
    def forward(ctx, a, b, dtype):
        a, b = _rounded(a, dtype), _rounded(b, dtype)
        ctx.save_for_backward(a, b)
        ctx.dtype = dtype
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _rounded(g, ctx.dtype)
        da = g @ b.t() if ctx.needs_input_grad[0] else None
        db = a.t() @ g if ctx.needs_input_grad[1] else None
        return da, db, None


def kernel_forward(params, obs, compute_dtype):
    """``actor_critic_forward`` as the update kernel computes it in
    ``compute_dtype``: every product, the heads' included, on operands
    rounded to it (``_RoundedMatmul``), biases, ``tanh`` and ``log_std`` in
    float32.  (The XLA path, ``actor_critic_forward(..., compute_dtype)``,
    keeps the heads in float32 and runs the trunks' biases and ``tanh`` in
    bf16; each path is mirrored as the JAX package has it.)"""
    actor, mu_l, critic, v_l, log_std = split_params(params)

    def dot(w, x):
        return _RoundedMatmul.apply(w, x, compute_dtype)

    a = c = obs
    for w, b in actor:
        a = torch.tanh(dot(w, a) + b)
    for w, b in critic:
        c = torch.tanh(dot(w, c) + b)
    mu = dot(mu_l[0], a) + mu_l[1]
    v = (dot(v_l[0], c) + v_l[1])[0]
    return mu, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX), v


def ppo_update_plain(flat, obs, pre, old_logp, adv, ret, clip: float = 0.2,
                     vf_coef: float = 0.5, ent_coef: float = 1e-3,
                     pre_tanh_reg: float = 1e-3, compute_dtype=None):
    """Plain version: autograd of ``learn/ppo.py``'s ``_make_cont_loss`` in
    the data's dtype, over ``kernel_forward`` with ``compute_dtype``.
    Returns ``(loss, grads)``, grads in the flat order."""
    from ..learn.ppo import PPOConfig, _make_cont_loss

    cfg = PPOConfig(clip=clip, vf_coef=vf_coef, ent_coef=ent_coef,
                    pre_tanh_reg=pre_tanh_reg)
    forward = None
    if compute_dtype is not None:
        def forward(params, x):
            return kernel_forward(params, x, compute_dtype)
    leaves = [p.detach().to(obs.dtype).requires_grad_(True)
              for p in flat_params(flat)]
    with torch.enable_grad():
        loss, _ = _make_cont_loss(cfg, forward)(leaves, obs, pre, old_logp,
                                                adv, ret)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), list(grads)


class _Launch:
    """What a launch of either mode needs that does not change from call
    to call, checked once against the library: its layout size and
    constants against the wrapper's plan, and for the bf16 mode the
    instance's shared memory, which the library reports; the layout ints
    on the card."""

    def __init__(self, layout: MlpLayout, M: int, bf16: bool, device):
        from ._build import library

        # the plan before the library: it refuses a net no kernel takes
        plan = ppo_update_bf16_plan(layout) if bf16 else {}
        self.kernel = plan.get("kernel", "float32")
        if self.kernel == "wgmma":
            self.entry = "ppo_update_bf16_launch"
            self.extra = (0, plan["H"], plan["layers"], plan["KP"],
                          plan["HA"])
            consts_fn, tile = "ppo_bf16_kernel_consts", _BF16_TS
            want, names = (_BF16_THREADS, _BF16_TS), "threads, tile"
        elif self.kernel == "mma":
            self.entry = "ppo_update_bf16_launch"
            self.smem, self.extra = plan["smem"], (1, 0, 0, 0, 0)
            consts_fn, tile = "ppo_bf16_mma_consts", _TS
            want = (_THREADS, _TS, _MMA_MAXQ, _MAXB)
            names = "threads, tile, tiles a warp, bias slots"
        else:
            self.entry = "ppo_update_launch"
            self.smem, self.extra = ppo_update_smem_bytes(layout), ()
            consts_fn, tile = "ppo_kernel_consts", _TS
            want = (_THREADS, _TS, _MAXQ, _MAXB)
            names = "threads, tile, slots, bias slots"
        self.G = min(_MAX_BLOCKS, -(-M // tile))
        lib = library()
        if lib.ppo_layout_ints() != LAYOUT_INTS:
            raise RuntimeError("MLP layout differs from the kernel's")
        consts = (ctypes.c_int * len(want))()
        getattr(lib, consts_fn)(consts)
        if tuple(consts) != want:
            raise RuntimeError(f"update kernel built with {tuple(consts)} "
                               f"({names}); the wrapper plans for {want}")
        if self.kernel == "wgmma":
            self.smem = lib.ppo_bf16_smem_bytes(*self.extra[1:])
            if not 0 < self.smem <= SMEM_MAX:
                raise RuntimeError(
                    f"bf16 update kernel instance {self.extra[1:]}: shared "
                    f"memory {self.smem} (-1: not built); the card has "
                    f"{SMEM_MAX}")
        self.layout = layout
        self.layout_dev = torch.as_tensor(layout.ints, device=device)


def _launch(prep: _Launch, flat, obs, pre, old_logp, adv, ret, clip,
            vf_coef, ent_coef, pre_tanh_reg):
    """Check the inputs, pack the weights and launch ``prep``'s entry on
    the current stream; returns ``(loss, grads)``."""
    from ._build import check, library
    from .supplychain_collect import _check

    layout, device = prep.layout, obs.device
    if device.type != "cuda" or prep.layout_dev.device != device:
        raise ValueError("the update kernel runs on the CUDA device it was "
                         "prepared for")
    O, A, M = layout.O, layout.A, obs.shape[-1]
    f32 = torch.float32
    _check(obs, "obs", f32, (O, M), device)
    _check(pre, "pre", f32, (A, M), device)
    for name, x in (("old_logp", old_logp), ("adv", adv), ("ret", ret)):
        _check(x, name, f32, (M,), device)
    flat = flat_params(flat)
    weights = layout.pack(flat)
    part = torch.empty((prep.G, layout.P), dtype=f32, device=device)
    out = torch.empty((layout.P,), dtype=f32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(library(), prep.entry)(
            prep.layout_dev.data_ptr(), weights.data_ptr(), prep.smem,
            prep.G, obs.data_ptr(), pre.data_ptr(), old_logp.data_ptr(),
            adv.data_ptr(), ret.data_ptr(), M, clip, 1.0 / M, vf_coef / M,
            ent_coef, pre_tanh_reg / (A * M), 2.0 * pre_tanh_reg / (A * M),
            part.data_ptr(), out.data_ptr(), layout.P, stream, *prep.extra)
    check(code, prep.entry)
    return out[-2] + out[-1], layout.unflat_grads(out, flat)


def launch_ppo_update(prep: _Launch, flat, obs, pre, old_logp, adv, ret,
                      clip: float, vf_coef: float, ent_coef: float,
                      pre_tanh_reg: float):
    """Launch the CUDA update kernel on the current stream, as ``prep``
    (made once by ``make_ppo_update_grads``) plans it.  Returns ``(loss,
    grads)``, grads as views of one buffer, shaped like ``flat``."""
    out = _launch(prep, flat, obs, pre, old_logp, adv, ret, clip, vf_coef,
                  ent_coef, pre_tanh_reg)
    count("launch.ppo_update")
    return out


def launch_ppo_update_bf16(prep: _Launch, flat, obs, pre, old_logp, adv, ret,
                           clip: float, vf_coef: float, ent_coef: float,
                           pre_tanh_reg: float):
    """Launch the bf16 update kernel (warpgroup tensor-core products) on the
    current stream; as ``launch_ppo_update``."""
    out = _launch(prep, flat, obs, pre, old_logp, adv, ret, clip, vf_coef,
                  ent_coef, pre_tanh_reg)
    count("launch.ppo_update_bf16")
    return out


def launch_ppo_update_bf16_mma(prep: _Launch, flat, obs, pre, old_logp, adv,
                               ret, clip: float, vf_coef: float,
                               ent_coef: float, pre_tanh_reg: float):
    """Launch the bf16 mode's mma.sync kernel (the nets no wgmma instance
    takes) on the current stream; as ``launch_ppo_update``."""
    out = _launch(prep, flat, obs, pre, old_logp, adv, ret, clip, vf_coef,
                  ent_coef, pre_tanh_reg)
    count("launch.ppo_update_bf16_mma")
    return out


def make_ppo_update_grads(obs_dim: int, act_dim: int, hidden, M: int,
                          clip: float = 0.2, vf_coef: float = 0.5,
                          ent_coef: float = 1e-3,
                          pre_tanh_reg: float = 1e-3, compute_dtype=None):
    """Build ``grads(params, obs, pre, old_logp, adv, ret) -> (loss,
    grads)`` for M samples.

    ``params`` is an ``ActorCritic`` or its flat list; ``grads`` come in
    the flat order (``ActorCritic.flat()``).  ``compute_dtype`` is ``None``
    (float32 products) or ``torch.bfloat16`` (bf16 operands, float32
    accumulation: the bf16 kernels, ``ppo_update_bf16_plan``; a net
    neither takes raises here).  CUDA tensors launch the kernel; CPU tensors
    run the plain version.
    """
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"compute_dtype {compute_dtype}: the update kernel "
                         "takes None (float32) or torch.bfloat16")
    bf16 = compute_dtype is not None
    layout = MlpLayout(obs_dim, act_dim, hidden)
    launch = launch_ppo_update
    if bf16:
        launch = {"wgmma": launch_ppo_update_bf16,
                  "mma": launch_ppo_update_bf16_mma}[
                      ppo_update_bf16_plan(layout)["kernel"]]
    consts = dict(clip=float(clip), vf_coef=float(vf_coef),
                  ent_coef=float(ent_coef), pre_tanh_reg=float(pre_tanh_reg))
    cache = {}

    def grads(params, obs, pre, old_logp, adv, ret):
        with span("ops.ppo_update"):
            if obs.shape[-1] != M:
                raise ValueError(f"{obs.shape[-1]} samples, built for {M}")
            if obs.device.type == "cpu":
                return ppo_update_plain(params, obs, pre, old_logp, adv, ret,
                                        compute_dtype=compute_dtype,
                                        **consts)
            if obs.device not in cache:        # the library checked once
                cache[obs.device] = _Launch(layout, M, bf16, obs.device)
            return launch(cache[obs.device], params, obs, pre, old_logp,
                          adv, ret, **consts)

    return grads


class PPOLossFn(torch.autograd.Function):
    """``loss = PPOLossFn.apply(grads_fn, data, *flat_params)``: the forward
    runs ``grads_fn`` (kernel or plain version) and keeps the gradients; the
    backward returns ``grad_out * grads``."""

    @staticmethod
    def forward(ctx, grads_fn, data, *params):
        loss, grads = grads_fn(list(params), *data)
        ctx.save_for_backward(*grads)
        return loss

    @staticmethod
    def backward(ctx, grad_out):
        return (None, None) + tuple(grad_out * g for g in ctx.saved_tensors)


def fused_ppo_loss(grads_fn, params, data):
    """The PPO loss of ``params`` on ``data = (obs, pre, old_logp, adv,
    ret)`` through ``grads_fn``, differentiable with respect to the
    parameters."""
    return PPOLossFn.apply(grads_fn, tuple(data), *flat_params(params))
