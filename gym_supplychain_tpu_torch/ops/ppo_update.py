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
The bf16 mode is a second kernel (``csrc/ppo_update_bf16.cu``) of the same
shape whose products run on the tensor cores (``mma.sync`` m16n8k16, bf16
operands, float32 accumulation; weights packed by ``MlpLayoutBf16``); its
plain version is autograd of the loss over ``kernel_forward``, each
product's operands and incoming gradient rounded to bf16.
``PPOLossFn`` wraps either as a ``torch.autograd.Function``: its forward
computes the loss and the gradients at once and its backward hands the
gradients back, so an update loop calls ``loss.backward()`` whichever ran.
"""
from __future__ import annotations

import ctypes

import torch

from ..models.policy import (LOG_STD_MAX, LOG_STD_MIN, flat_params,
                             split_params)
from ._mlp import LAYOUT_INTS, SMEM_MAX, MlpLayout, MlpLayoutBf16, _pad16

__all__ = ["make_ppo_update_grads", "launch_ppo_update",
           "launch_ppo_update_bf16", "ppo_update_plain", "kernel_forward",
           "ppo_update_smem_bytes", "ppo_update_slots",
           "ppo_update_bf16_smem_bytes", "ppo_update_bf16_tiles",
           "PPOLossFn", "fused_ppo_loss"]

_THREADS = 512             # threads a block (PU_THREADS)
_TS, _LD = 64, 68          # samples a tile, row stride of the tile buffers
_MAXQ, _MAXB = 3, 2        # gradient register slots a thread (PU_MAXQ, PU_MAXB)
_STATIC = 4 * (LAYOUT_INTS + 2 * _TS)   # static shared memory
_MAX_BLOCKS = 66           # blocks per net: 2 * 66 fill the H100's 132 SMs
_BF16_MAXQ = 12            # 16x8 weight-gradient tiles a warp (PB_MAXQ)
_BF16_LDB = 72             # row stride (bf16) of the bf16 tile buffers
_WARPS = _THREADS // 32


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


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


def ppo_update_bf16_tiles(layout: MlpLayout):
    """16x8 weight-gradient tiles of the bf16 kernel, per net (actor,
    critic): ``ceil(J/16) * ceil(K/8)`` a layer, dealt round-robin over the
    block's 16 warps.  Raises where a warp would hold more than its register
    slots, or a net more biases than its bias slots cover."""
    out = []
    for net, rows in enumerate(layout.layers):
        tiles = sum(-(-J // 16) * -(-K // 8) for K, J, *_ in rows)
        biases = sum(J for _, J, *_ in rows)
        if -(-tiles // _WARPS) > _BF16_MAXQ or biases > _MAXB * _THREADS:
            raise NotImplementedError(
                f"actor-critic O={layout.O}, A={layout.A}, hidden="
                f"{layout.hidden}: the {('actor', 'critic')[net]}'s gradient "
                f"needs {tiles} tiles and {biases} bias slots a block; the "
                f"bf16 update kernel holds {_BF16_MAXQ * _WARPS} and "
                f"{_MAXB * _THREADS}")
        out.append(tiles)
    return tuple(out)


def ppo_update_bf16_smem_bytes(layout: MlpLayoutBf16) -> int:
    """Dynamic shared memory of the bf16 kernel's larger block: its net's
    section (``MlpLayoutBf16``), the bf16 tiles ``[pad16(rows)][72]`` of the
    obs and each hidden layer's output, their float32 copies
    ``[pad16(rows)][68]``, the head's output (float32) and gradient (bf16),
    z and the log-prob terms, and two input slots.  Raises where a block
    would exceed the card's shared memory or a warp's gradient registers
    (``ppo_update_bf16_tiles``)."""
    ppo_update_bf16_tiles(layout)
    slot_rows = _pad8(layout.O) + layout.A + 3
    widths = [_pad16(h) for h in layout.hidden]
    sizes = []
    for net in (0, 1):
        head = layout.head_rows[net]
        sizes.append(4 * layout.wsec[net]
                     + 2 * _BF16_LDB * (_pad16(layout.O) + sum(widths) + head)
                     + 4 * _LD * (sum(widths) + head + 2 * _pad8(layout.A)
                                  + 2 * slot_rows))
    dyn = max(sizes)
    if dyn + _STATIC > SMEM_MAX:
        raise NotImplementedError(
            f"actor-critic O={layout.O}, A={layout.A}, hidden="
            f"{layout.hidden} needs {dyn + _STATIC} bytes of shared memory "
            f"per block; the bf16 update kernel has {SMEM_MAX}")
    return dyn


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


def _launch(entry, consts_fn, plan, smem, layout, layout_dev, flat, obs,
            pre, old_logp, adv, ret, clip, vf_coef, ent_coef, pre_tanh_reg):
    """Check the inputs and the library's constants, pack the weights and
    launch ``entry`` on the current stream; returns ``(loss, grads)``."""
    from ._build import check, library
    from .supplychain_collect import _check

    device = obs.device
    if device.type != "cuda":
        raise ValueError("the update kernel runs on a CUDA device")
    O, A, M = layout.O, layout.A, obs.shape[-1]
    f32 = torch.float32
    _check(layout_dev, "layout", torch.int32, (LAYOUT_INTS,), device)
    _check(obs, "obs", f32, (O, M), device)
    _check(pre, "pre", f32, (A, M), device)
    for name, x in (("old_logp", old_logp), ("adv", adv), ("ret", ret)):
        _check(x, name, f32, (M,), device)
    lib = library()
    if lib.ppo_layout_ints() != LAYOUT_INTS:
        raise RuntimeError("MLP layout differs from the kernel's")
    consts = (ctypes.c_int * 4)()
    getattr(lib, consts_fn)(consts)
    if tuple(consts) != plan:
        raise RuntimeError(f"update kernel built with {tuple(consts)} "
                           "(threads, tile, slots, bias slots); the wrapper "
                           f"plans for {plan}")
    flat = flat_params(flat)
    weights = layout.pack(flat)
    G = min(_MAX_BLOCKS, -(-M // _TS))
    part = torch.empty((G, layout.P), dtype=f32, device=device)
    out = torch.empty((layout.P,), dtype=f32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, entry)(
            layout_dev.data_ptr(), weights.data_ptr(), smem, G,
            obs.data_ptr(), pre.data_ptr(), old_logp.data_ptr(),
            adv.data_ptr(), ret.data_ptr(), M, clip, 1.0 / M, vf_coef / M,
            ent_coef, pre_tanh_reg / (A * M), 2.0 * pre_tanh_reg / (A * M),
            part.data_ptr(), out.data_ptr(), layout.P, stream)
    check(code, entry)
    return out[-2] + out[-1], layout.unflat_grads(out, flat)


def launch_ppo_update(layout: MlpLayout, layout_dev: torch.Tensor,
                      flat, obs, pre, old_logp, adv, ret, clip: float,
                      vf_coef: float, ent_coef: float, pre_tanh_reg: float):
    """Launch the CUDA update kernel on the current stream.  ``layout_dev``
    is ``layout.ints`` on the card.  Returns ``(loss, grads)``, grads as
    views of one buffer, shaped like ``flat``."""
    out = _launch("ppo_update_launch", "ppo_kernel_consts",
                  (_THREADS, _TS, _MAXQ, _MAXB), ppo_update_smem_bytes(layout),
                  layout, layout_dev, flat, obs, pre, old_logp, adv, ret,
                  clip, vf_coef, ent_coef, pre_tanh_reg)
    launch_ppo_update.launches += 1
    return out


launch_ppo_update.launches = 0


def launch_ppo_update_bf16(layout: MlpLayoutBf16, layout_dev: torch.Tensor,
                           flat, obs, pre, old_logp, adv, ret, clip: float,
                           vf_coef: float, ent_coef: float,
                           pre_tanh_reg: float):
    """Launch the bf16 update kernel (tensor-core products) on the current
    stream; as ``launch_ppo_update`` with ``layout.ints`` of an
    ``MlpLayoutBf16``."""
    out = _launch("ppo_update_bf16_launch", "ppo_bf16_kernel_consts",
                  (_THREADS, _TS, _BF16_MAXQ, _MAXB),
                  ppo_update_bf16_smem_bytes(layout), layout, layout_dev,
                  flat, obs, pre, old_logp, adv, ret, clip, vf_coef, ent_coef,
                  pre_tanh_reg)
    launch_ppo_update_bf16.launches += 1
    return out


launch_ppo_update_bf16.launches = 0


def make_ppo_update_grads(obs_dim: int, act_dim: int, hidden, M: int,
                          clip: float = 0.2, vf_coef: float = 0.5,
                          ent_coef: float = 1e-3,
                          pre_tanh_reg: float = 1e-3, compute_dtype=None):
    """Build ``grads(params, obs, pre, old_logp, adv, ret) -> (loss,
    grads)`` for M samples.

    ``params`` is an ``ActorCritic`` or its flat list; ``grads`` come in
    the flat order (``ActorCritic.flat()``).  ``compute_dtype`` is ``None``
    (float32 products) or ``torch.bfloat16`` (bf16 operands, float32
    accumulation: the bf16 kernel).  CUDA tensors launch the kernel; CPU
    tensors run the plain version.
    """
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"compute_dtype {compute_dtype}: the update kernel "
                         "takes None (float32) or torch.bfloat16")
    bf16 = compute_dtype is not None
    layout = (MlpLayoutBf16 if bf16 else MlpLayout)(obs_dim, act_dim, hidden)
    launch = launch_ppo_update_bf16 if bf16 else launch_ppo_update
    consts = dict(clip=float(clip), vf_coef=float(vf_coef),
                  ent_coef=float(ent_coef), pre_tanh_reg=float(pre_tanh_reg))
    cache = {}

    def grads(params, obs, pre, old_logp, adv, ret):
        if obs.shape[-1] != M:
            raise ValueError(f"{obs.shape[-1]} samples, built for {M}")
        if obs.device.type == "cpu":
            return ppo_update_plain(params, obs, pre, old_logp, adv, ret,
                                    compute_dtype=compute_dtype, **consts)
        if obs.device not in cache:
            cache[obs.device] = torch.as_tensor(layout.ints,
                                                device=obs.device)
        return launch(layout, cache[obs.device], params, obs, pre, old_logp,
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
