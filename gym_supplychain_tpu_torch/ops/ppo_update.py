"""Fused clipped-PPO update: CUDA kernel, plain version, autograd wrapper.

Replaces the TPU kernel ``make_ppo_update_grads`` of
``gym_supplychain_tpu/ops/ppo_update_pallas.py`` (``_kernel``): the
actor-critic forward, the clipped-PPO loss of ``learn/ppo.py``'s
``_make_cont_loss`` and its hand-derived backward over M samples, giving
the scalar loss and the gradient of every parameter.  Data is
sample-trailing (``obs [O, M]``, ``pre [A, M]``, ``old_logp``, ``adv``,
``ret [M]``; advantages already normalized); float32 only.

The kernel (``csrc/ppo_update.cu``) splits the actor and the critic over
two rows of blocks, walks 32-sample tiles with the weights and gradient
accumulators in shared memory, writes per-block partial gradients and
sums them in a fixed order, so two launches on the same inputs give the
same gradients.  Its plain version is autograd of the PyTorch loss.
``PPOLossFn`` wraps either as a ``torch.autograd.Function``: its forward
computes the loss and the gradients at once and its backward hands the
gradients back, so an update loop calls ``loss.backward()`` whichever ran.
"""
from __future__ import annotations

import torch

from ..models.policy import flat_params
from ._mlp import LAYOUT_INTS, SMEM_MAX, MlpLayout

__all__ = ["make_ppo_update_grads", "launch_ppo_update", "ppo_update_plain",
           "ppo_update_smem_bytes", "PPOLossFn", "fused_ppo_loss"]

_TS, _LD = 32, 33          # samples a tile, row stride of the tile buffers
_MAX_BLOCKS = 66           # blocks per net: 2 * 66 fill the H100's 132 SMs


def ppo_update_smem_bytes(layout: MlpLayout) -> int:
    """Dynamic shared memory of the update kernel's larger block: its net's
    packed weights and gradient accumulators, and the tile's obs,
    activations, head and head-gradient buffers.  Raises where a block
    would exceed the card's shared memory."""
    sizes = []
    for net, (wlen, glen) in enumerate(((layout.wsec[0],
                                         layout.La + layout.A),
                                        (layout.wsec[1], layout.Lc))):
        rows = layout.O + sum(layout.hidden) + 2 * layout.head_rows[net]
        sizes.append(4 * (wlen + glen + rows * _LD))
    dyn = max(sizes)
    static = 4 * (LAYOUT_INTS + _TS)
    if dyn + static > SMEM_MAX:
        raise NotImplementedError(
            f"actor-critic O={layout.O}, A={layout.A}, hidden="
            f"{layout.hidden} needs {dyn + static} bytes of shared memory "
            f"per block; the update kernel has {SMEM_MAX}")
    return dyn


def ppo_update_plain(flat, obs, pre, old_logp, adv, ret, clip: float = 0.2,
                     vf_coef: float = 0.5, ent_coef: float = 1e-3,
                     pre_tanh_reg: float = 1e-3):
    """Plain version: autograd of ``learn/ppo.py``'s ``_make_cont_loss`` in
    the data's dtype.  Returns ``(loss, grads)``, grads in the flat order."""
    from ..learn.ppo import PPOConfig, _make_cont_loss

    cfg = PPOConfig(clip=clip, vf_coef=vf_coef, ent_coef=ent_coef,
                    pre_tanh_reg=pre_tanh_reg)
    leaves = [p.detach().to(obs.dtype).requires_grad_(True)
              for p in flat_params(flat)]
    with torch.enable_grad():
        loss, _ = _make_cont_loss(cfg)(leaves, obs, pre, old_logp, adv, ret)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), list(grads)


def launch_ppo_update(layout: MlpLayout, layout_dev: torch.Tensor,
                      flat, obs, pre, old_logp, adv, ret, clip: float,
                      vf_coef: float, ent_coef: float, pre_tanh_reg: float):
    """Launch the CUDA update kernel on the current stream.  ``layout_dev``
    is ``layout.ints`` on the card.  Returns ``(loss, grads)``, grads as
    views of one buffer, shaped like ``flat``."""
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
    smem = ppo_update_smem_bytes(layout)
    lib = library()
    if lib.ppo_layout_ints() != LAYOUT_INTS:
        raise RuntimeError("MLP layout differs from the kernel's")
    flat = flat_params(flat)
    weights = layout.pack(flat)
    G = min(_MAX_BLOCKS, -(-M // _TS))
    part = torch.empty((G, layout.P), dtype=f32, device=device)
    out = torch.empty((layout.P,), dtype=f32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.ppo_update_launch(
            layout_dev.data_ptr(), weights.data_ptr(), smem, G,
            obs.data_ptr(), pre.data_ptr(), old_logp.data_ptr(),
            adv.data_ptr(), ret.data_ptr(), M, clip, 1.0 / M, vf_coef / M,
            ent_coef, pre_tanh_reg / (A * M), 2.0 * pre_tanh_reg / (A * M),
            part.data_ptr(), out.data_ptr(), layout.P, stream)
    check(code, "ppo update")
    launch_ppo_update.launches += 1
    return out[-2] + out[-1], layout.unflat_grads(out, flat)


launch_ppo_update.launches = 0


def make_ppo_update_grads(obs_dim: int, act_dim: int, hidden, M: int,
                          clip: float = 0.2, vf_coef: float = 0.5,
                          ent_coef: float = 1e-3,
                          pre_tanh_reg: float = 1e-3):
    """Build ``grads(params, obs, pre, old_logp, adv, ret) -> (loss,
    grads)`` for M samples.

    ``params`` is an ``ActorCritic`` or its flat list; ``grads`` come in
    the flat order (``ActorCritic.flat()``).  CUDA tensors launch the
    kernel; CPU tensors run the plain version.
    """
    layout = MlpLayout(obs_dim, act_dim, hidden)
    consts = dict(clip=float(clip), vf_coef=float(vf_coef),
                  ent_coef=float(ent_coef), pre_tanh_reg=float(pre_tanh_reg))
    cache = {}

    def grads(params, obs, pre, old_logp, adv, ret):
        if obs.shape[-1] != M:
            raise ValueError(f"{obs.shape[-1]} samples, built for {M}")
        if obs.device.type == "cpu":
            return ppo_update_plain(params, obs, pre, old_logp, adv, ret,
                                    **consts)
        if obs.device not in cache:
            ppo_update_smem_bytes(layout)
            cache[obs.device] = torch.as_tensor(layout.ints,
                                                device=obs.device)
        return launch_ppo_update(layout, cache[obs.device], params, obs, pre,
                                 old_logp, adv, ret, **consts)

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
