"""Deterministic pseudorandom hashing used across Skueue.

Counterpart of ``repro/core/hashing.py``.  The paper assumes "a publicly
known pseudorandom hash function" both for node labels (LDB middle-node
positions) and for the consistent-hashing DHT keys ``k(p)``: splitmix64.

Each function has two forms.  Given a ``torch.Tensor`` it returns a tensor
on the input's device: torch has no full uint64 arithmetic, so the 64 bits
are held in int64 (multiplication, addition and xor wrap to the same bits;
a logical right shift masks off the sign's copies), and ``splitmix64``
returns those bits as int64.  Given a Python int or a numpy array it
computes in numpy uint64 as the reference does: the protocol simulator
hashes one position per message, where a 0-d tensor would cost torch's
dispatch on every call.
"""
from __future__ import annotations

import numpy as np
import torch

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)
_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)


def _signed(c: np.uint64) -> int:
    """The int64 holding the bits of the uint64 constant ``c``."""
    return int(c.astype(np.int64))


def shr64(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of the uint64 bits held in int64 ``z``."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def umod64(z: torch.Tensor, m: int) -> torch.Tensor:
    """``z mod m`` for the uint64 bits held in int64 ``z`` and ``0 < m <
    2^31``, from the two 32-bit halves (a signed ``%`` of a negative int64
    would read the bits as a negative number)."""
    hi, lo = shr64(z, 32), z & 0xFFFFFFFF
    return ((hi % m) * ((1 << 32) % m) + lo) % m


def _splitmix64_t(z: torch.Tensor) -> torch.Tensor:
    z = z + _signed(_GOLDEN)
    z = (z ^ shr64(z, 30)) * _signed(_M1)
    z = (z ^ shr64(z, 27)) * _signed(_M2)
    return z ^ shr64(z, 31)


def splitmix64(x):
    """Vectorized splitmix64 finalizer.  A tensor gives an int64 tensor of
    the uint64 bits; an int or array gives numpy uint64."""
    if isinstance(x, torch.Tensor):
        return _splitmix64_t(x.to(torch.int64))
    z = (np.asarray(x, dtype=np.uint64) + _GOLDEN) & _MASK
    z = ((z ^ (z >> np.uint64(30))) * _M1) & _MASK
    z = ((z ^ (z >> np.uint64(27))) * _M2) & _MASK
    return z ^ (z >> np.uint64(31))


def hash01(x, salt: int = 0):
    """Hash ints to floats uniform in [0, 1), float64.  Deterministic."""
    if isinstance(x, torch.Tensor):
        with np.errstate(over="ignore"):
            s = _signed(splitmix64(np.uint64(salt)))
        z = _splitmix64_t(x.to(torch.int64) ^ s)
        # 53-bit mantissa for an unbiased float64 in [0, 1)
        return shr64(z, 11).to(torch.float64) * (1.0 / (1 << 53))
    with np.errstate(over="ignore"):
        z = splitmix64(np.asarray(x, dtype=np.uint64)
                       ^ splitmix64(np.uint64(salt)))
    return (z >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))


def position_key(pos, salt: int = 0xD47):
    """DHT key k(p) in [0,1) for queue position p (paper Sec. II-B)."""
    return hash01(pos, salt=salt)
