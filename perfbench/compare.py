"""The numbers that decide ``correct``, and the seeds every cell draws from.

Each number compared is a gap between what the program produced and what
the plain reference (``perfbench/reference``) computes from the same
inputs; each has a limit of its own in the cell's traffic file.
"""
from __future__ import annotations

import random
import statistics

import torch

__all__ = ["call_seed", "sampled_calls", "rel_gap", "max_abs_gap",
           "leaf_norm_gap", "quiet_leaves", "stats"]

_MASK64 = 2 ** 64 - 1


def call_seed(seed: int, i: int) -> int:
    """The 64-bit seed of call ``i`` of a run seeded ``seed`` (splitmix64
    of the pair, so every call's rows differ)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (i + 1) * 0xBF58476D1CE4E5B9) \
        & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def sampled_calls(seed: int, k: int, upto: int):
    """``k`` call indices in ``[0, upto)`` drawn from the run's seed."""
    return set(random.Random(int(seed)).sample(range(upto), k))


def rel_gap(prog, ref) -> float:
    """``|prog - ref| / |ref|`` of two numbers."""
    return abs(float(prog) - float(ref)) / abs(float(ref))


def max_abs_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest elementwise ``|prog - ref|`` (NaN reads infinite)."""
    d = (prog.to(torch.float32) - ref.to(torch.float32)).abs()
    return float(torch.nan_to_num(d, nan=float("inf")).max())


def _norms(leaves):
    return [float(torch.linalg.vector_norm(x.to(torch.float32)))
            for x in leaves]


def quiet_leaves(ref_grads, share: float = 1e-3):
    """Indices of the leaves whose reference gradient's norm is under
    ``share`` of the median leaf's: gradients nought to rounding, which Adam
    moves by round-off alone."""
    n = _norms(ref_grads)
    med = statistics.median(n)
    return {i for i, x in enumerate(n) if x < share * med}


def leaf_norm_gap(prog, ref, skip=()) -> float:
    """The worst leaf's ``| |prog| - |ref| |`` over the larger of its
    reference norm and the median leaf's reference norm."""
    np_, nr = _norms(prog), _norms(ref)
    med = statistics.median(nr)
    gaps = [abs(a - b) / max(b, med)
            for i, (a, b) in enumerate(zip(np_, nr)) if i not in skip]
    return max(gaps)


def stats(per_env: torch.Tensor) -> dict:
    """An evaluation's statistics of per-lane returns ``[B]``."""
    return {"mean_return": float(per_env.mean()),
            "std_return": float(per_env.std(correction=0)),
            "min_return": float(per_env.min()),
            "max_return": float(per_env.max())}
