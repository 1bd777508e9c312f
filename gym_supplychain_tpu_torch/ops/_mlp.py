"""The actor-critic weights as the CUDA kernels read them.

Both kernels that run the MLP (the collect kernel's policy modes and the
PPO update kernel) take one packed float32 buffer and an int32 layout.  The
buffer holds the actor section (each layer's ``w`` transposed to
``[K, Jp]`` then its bias ``[Jp]``, with ``J`` padded to ``Jp``, a multiple
of 8, so a thread loads 8 rows of a column as two float4; then ``log_std``)
and the critic section, in the ``_flat_actor_critic`` order.  The layout
names every layer's sizes and offsets, and the offsets of its gradient in
the flat gradient row of the update kernel (``w [J, K]`` then ``b [J]``
per layer, actor then critic then ``log_std``: the flat parameter order).

Layout ints: ``[nL, O, A, wsec0, wsec1, ls_woff, La, Lc, P, Hmax]``, then
per net (actor, critic) and layer (hidden layers, then the head) seven ints
``K, J, Jp, w_off, b_off, gw_off, gb_off``; weight offsets count from the
net's section, gradient offsets from the net's gradient section.  ``P`` is
the gradient row's length: the ``La + Lc + A`` gradients and 2 loss slots.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.policy import split_params

MAX_LAYERS = 4          # hidden layers the kernels take
SMEM_MAX = 232448       # shared memory a block may use on the H100
HEADER = 10
PER_LAYER = 7
LAYOUT_INTS = HEADER + 2 * (MAX_LAYERS + 1) * PER_LAYER


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


class MlpLayout:
    """Sizes and offsets of an actor-critic for the CUDA kernels."""

    def __init__(self, obs_dim: int, act_dim: int, hidden):
        hidden = tuple(int(h) for h in hidden)
        if not 1 <= len(hidden) <= MAX_LAYERS:
            raise NotImplementedError(
                f"the kernels take 1 to {MAX_LAYERS} hidden layers, got "
                f"{len(hidden)}")
        self.O, self.A, self.hidden = int(obs_dim), int(act_dim), hidden
        self.nL = len(hidden)
        self.layers = []                  # per net: [(K, J, Jp, w, b, gw, gb)]
        wsec, gsec = [], []
        for head in (self.A, 1):
            rows, w_off, g_off, n_in = [], 0, 0, self.O
            for J in hidden + (head,):
                Jp = _pad8(J)
                rows.append((n_in, J, Jp, w_off, w_off + n_in * Jp,
                             g_off, g_off + J * n_in))
                w_off += n_in * Jp + Jp
                g_off += J * n_in + J
                n_in = J
            self.layers.append(rows)
            wsec.append(w_off)
            gsec.append(g_off)
        self.ls_woff = wsec[0]
        wsec[0] += _pad8(self.A)
        self.wsec = wsec
        self.La, self.Lc = gsec
        self.P = self.La + self.Lc + self.A + 2
        self.n_params = self.La + self.Lc + self.A
        ints = [self.nL, self.O, self.A, wsec[0], wsec[1], self.ls_woff,
                self.La, self.Lc, self.P, max(hidden)]
        ints += [0] * (LAYOUT_INTS - len(ints))
        for net, rows in enumerate(self.layers):
            for l, row in enumerate(rows):
                base = HEADER + (net * (MAX_LAYERS + 1) + l) * PER_LAYER
                ints[base:base + PER_LAYER] = row
        self.ints = np.asarray(ints, np.int32)

    @property
    def head_rows(self):
        """Padded rows of the actor and the critic heads."""
        return self.layers[0][-1][2], self.layers[1][-1][2]

    def pack(self, flat) -> torch.Tensor:
        """Flat parameters (``_flat_actor_critic`` order) -> the packed
        float32 buffer, on the parameters' device."""
        flat = [p.detach().to(torch.float32) for p in flat]
        if len(flat) != 4 * self.nL + 5:
            raise ValueError(f"{len(flat)} tensors for {self.nL} hidden "
                             "layers")
        actor, mu, critic, v, _ = split_params(flat)
        nets = (actor + [mu], critic + [v])
        parts = []
        for net, rows in enumerate(self.layers):
            for l, (K, J, Jp, *_) in enumerate(rows):
                w, b = nets[net][l]
                if tuple(w.shape) != (J, K) or tuple(b.shape) != (J, 1):
                    raise ValueError(f"layer {l} of net {net}: w "
                                     f"{tuple(w.shape)}, b {tuple(b.shape)}; "
                                     f"expected ({J}, {K}), ({J}, 1)")
                parts.append(torch.nn.functional.pad(w.t(), (0, Jp - J))
                             .reshape(-1))
                parts.append(torch.nn.functional.pad(b.reshape(-1),
                                                     (0, Jp - J)))
            if net == 0:
                ls = flat[-1].reshape(-1)
                parts.append(torch.nn.functional.pad(
                    ls, (0, _pad8(self.A) - self.A)))
        out = torch.cat(parts).contiguous()
        assert out.numel() == self.wsec[0] + self.wsec[1]
        return out

    def unflat_grads(self, row: torch.Tensor, like):
        """The first ``n_params`` floats of a gradient row -> views shaped
        like the flat parameters ``like``."""
        out, off = [], 0
        for p in like:
            out.append(row[off:off + p.numel()].view(p.shape))
            off += p.numel()
        assert off == self.n_params
        return out
