"""Replication of classic OpenAI Gym seeding + ``Box.sample`` streams.

The port's copy of ``gym_supplychain_tpu/rng/gym_compat.py`` (numpy only).

The reference's golden episodic-return regression tests drive the env with
``env.action_space.sample()`` after ``env.seed(seed)``, which hard-seeds the
action space with 0 (reference supplychain_env.py:811-813).  Classic gym
(the 0.1x line the reference CI used) seeds a ``numpy.random.RandomState`` via
``gym.utils.seeding``'s well-known sha512 hash-seed scheme and samples a
bounded Box with one ``uniform(low, high, size)`` call cast to the space dtype.
We replicate those public algorithms here so the golden-return values recorded
in the reference test suite (e.g. test_multiproduct_2perstage.py:221-309,
test_Nperstage.py:23-53) can be verified without gym installed.
"""
from __future__ import annotations

import hashlib
import struct

import numpy as np

__all__ = ["hash_seed", "create_seed", "old_gym_np_random", "OldGymBox"]


def _bigint_from_bytes(bt: bytes) -> int:
    sizeof_int = 4
    padding = sizeof_int - len(bt) % sizeof_int
    bt += b"\0" * padding
    int_count = len(bt) // sizeof_int
    unpacked = struct.unpack(f"{int_count}I", bt)
    accum = 0
    for i, val in enumerate(unpacked):
        accum += 2 ** (sizeof_int * 8 * i) * val
    return accum


def _int_list_from_bigint(bigint: int):
    if bigint < 0:
        raise ValueError("seed must be non-negative")
    if bigint == 0:
        return [0]
    ints = []
    while bigint > 0:
        bigint, mod = divmod(bigint, 2 ** 32)
        ints.append(mod)
    return ints


def hash_seed(seed: int, max_bytes: int = 8) -> int:
    digest = hashlib.sha512(str(seed).encode("utf8")).digest()
    return _bigint_from_bytes(digest[:max_bytes])


def create_seed(seed=None, max_bytes: int = 8) -> int:
    if seed is None:
        seed = _bigint_from_bytes(np.random.bytes(max_bytes))
    elif isinstance(seed, int):
        seed = seed % 2 ** (8 * max_bytes)
    else:
        raise ValueError(f"invalid seed: {seed!r}")
    return seed


def old_gym_np_random(seed=None) -> np.random.RandomState:
    """``gym.utils.seeding.np_random`` stream (classic gym)."""
    seed = create_seed(seed)
    rs = np.random.RandomState()
    rs.seed(_int_list_from_bigint(hash_seed(seed)))
    return rs


class OldGymBox:
    """Minimal Box(-1, 1, shape, float32) with the classic gym sample stream."""

    def __init__(self, low: float, high: float, shape, dtype=np.float32):
        self.low = np.full(shape, low, dtype)
        self.high = np.full(shape, high, dtype)
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.np_random = old_gym_np_random(None)

    def seed(self, seed=None):
        self.np_random = old_gym_np_random(seed)

    def sample(self) -> np.ndarray:
        # all dimensions are bounded -> one uniform(low, high) draw, cast
        sample = self.np_random.uniform(low=self.low, high=self.high,
                                        size=self.shape)
        return sample.astype(self.dtype)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == self.shape and bool(
            (x >= self.low).all() and (x <= self.high).all())
