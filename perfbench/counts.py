"""Operations and bytes of the program's kernels, from shapes alone, and
the card's peaks.

A bound is the least time the card could take: the larger of the bytes a
kernel must move (inputs read once, outputs written once) over the memory
rate and the operations it must do over the float32 rate outside the
tensor cores (the configurations run float32 with TF32 off).  The env
step's scalar operations are not counted, so a bound stays a lower bound.
The peaks are the H100 SXM data sheet's at its 700 W limit.
"""
from __future__ import annotations

__all__ = ["PEAK_FLOPS", "PEAK_BF16", "PEAK_BYTES", "bound", "mlp_layout",
           "macs", "issue_bound_ms", "collect_bound", "k1_policy_bound",
           "k2_flops", "k2_bound", "k4_bound", "train_flops", "eval_flops"]

PEAK_FLOPS = 67e12         # float32 outside the tensor cores
PEAK_BF16 = 989e12         # bf16 tensor cores, dense
PEAK_BYTES = 3.35e12       # HBM3


def bound(n_bytes, n_flops, peak_flops=PEAK_FLOPS):
    """(ms, 'bytes' or 'operations')."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_flops / peak_flops
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def mlp_layout(O: int, A: int, hidden):
    """The actor-critic as the kernels hold it: per net (0 the actor with
    its mu head, 1 the critic with its v head) the layers' ``(in, out)``;
    the packed weight sections' words (rows padded to 8, ``log_std`` after
    the actor); the parameters' count."""
    hidden = tuple(int(h) for h in hidden)
    layers, wsec = [], []
    for head in (A, 1):
        rows, words, n_in = [], 0, O
        for J in hidden + (head,):
            rows.append((n_in, J))
            words += n_in * _pad8(J) + _pad8(J)
            n_in = J
        layers.append(rows)
        wsec.append(words)
    wsec[0] += _pad8(A)
    n_params = sum(K * J + J for rows in layers for K, J in rows) + A
    return {"layers": layers, "wsec": wsec, "n_params": n_params}


def macs(layout, nets):
    """Multiply-adds of one forward pass of ``nets`` for one sample."""
    return sum(K * J for net in nets for K, J in layout["layers"][net])


def issue_bound_ms(n_macs):
    """The least time of ``n_macs`` multiply-adds without FMA contraction
    (the collect kernels' float rules forbid it): an FMUL and an FADD each,
    at one float32 instruction a lane a clock."""
    return 1e3 * 2 * n_macs / (PEAK_FLOPS / 2)


def collect_bound(O, N, P, S, B):
    """A collection of S steps of B envs: obs [S, O, B], reward [S, B] and
    the final stock out, float32."""
    return bound(4 * B * (S * (O + 1) + N * P), 0)


def k1_policy_bound(O, A, N, P, hidden, S, B):
    """The policy lane kernel collecting S steps of B envs: the weights in;
    obs, pre-tanh action, log-prob, value, reward and the final stock out;
    the actor's and the critic's forward a sample."""
    lay, M = mlp_layout(O, A, hidden), S * B
    return bound(4 * (sum(lay["wsec"]) + M * (O + A + 3) + N * P * B),
                 2 * macs(lay, [0, 1]) * M)


def k2_flops(O, A, hidden, M):
    """One update kernel call over M samples: the forward, the weight
    gradients and the input gradients past the first layer."""
    lay = mlp_layout(O, A, hidden)
    return 2 * M * (3 * macs(lay, [0, 1]) - 2 * O * int(hidden[0]))


def k2_bound(O, A, hidden, M, peak_flops=PEAK_FLOPS):
    """obs, pre and three [M] rows and the weights in, the gradients out."""
    lay = mlp_layout(O, A, hidden)
    return bound(4 * (M * (O + A + 3) + 2 * lay["n_params"]),
                 k2_flops(O, A, hidden, M), peak_flops)


def k4_bound(O, A, N, P, R, K, hidden, T, B):
    """The greedy episode kernel: the demand [T+1, R, P, B] and lead-time
    [T, K, B] tables and the actor's weights in, rewards [T, B] and the
    final stock out; the actor's forward a step."""
    lay = mlp_layout(O, A, hidden)
    tables = 4 * ((T + 1) * R * P * B + T * K * B)
    return bound(tables + 4 * (T * B + N * P * B) + 4 * lay["wsec"][0],
                 2 * macs(lay, [0]) * T * B)


def train_flops(O, A, hidden, M, epochs):
    """Model operations of one fused iteration over M samples: the
    rollout's actor and critic forward, then ``epochs`` update calls."""
    lay = mlp_layout(O, A, hidden)
    return 2 * macs(lay, [0, 1]) * M + epochs * k2_flops(O, A, hidden, M)


def eval_flops(O, A, hidden, T, B):
    """Model operations of one greedy episode: the actor's forward."""
    return 2 * macs(mlp_layout(O, A, hidden), [0]) * T * B
