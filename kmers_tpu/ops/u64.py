"""Vectorized 64-bit unsigned arithmetic as (hi, lo) uint32 pairs.

JAX keeps 64-bit integers off by default, so this module is the framework's "NTuple of
UInt64 register" analogue (SURVEY.md §7 design stance): a batched 64-bit
word is a pair of uint32 arrays, and every kmer-register operation
(shift-carry, compare, FxHash multiply) is expressed in uint32 ops.
Works identically on every backend.

A U64 is simply a ``(hi, lo)`` tuple of same-shape uint32 arrays.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "u64",
    "from_scalar",
    "xor",
    "and_",
    "or_",
    "shl",
    "shr",
    "rotl",
    "mul",
    "add",
    "eq",
    "ne",
    "lt",
    "le",
    "select",
    "minimum",
    "to_numpy",
]

_U32 = jnp.uint32


def u64(hi, lo):
    return (jnp.asarray(hi, _U32), jnp.asarray(lo, _U32))


def from_scalar(x: int, shape=()):
    """Broadcast a Python int to a U64 of the given shape."""
    hi = jnp.full(shape, (x >> 32) & 0xFFFFFFFF, _U32)
    lo = jnp.full(shape, x & 0xFFFFFFFF, _U32)
    return (hi, lo)


def xor(a, b):
    return (a[0] ^ b[0], a[1] ^ b[1])


def and_(a, b):
    return (a[0] & b[0], a[1] & b[1])


def or_(a, b):
    return (a[0] | b[0], a[1] | b[1])


def shl(a, k: int):
    """Logical left shift by a static 0 <= k < 64."""
    hi, lo = a
    if k == 0:
        return a
    if k < 32:
        return ((hi << k) | (lo >> (32 - k)), lo << k)
    return (lo << (k - 32) if k > 32 else lo, jnp.zeros_like(lo))


def shr(a, k: int):
    """Logical right shift by a static 0 <= k < 64."""
    hi, lo = a
    if k == 0:
        return a
    if k < 32:
        return (hi >> k, (lo >> k) | (hi << (32 - k)))
    return (jnp.zeros_like(hi), hi >> (k - 32) if k > 32 else hi)


def rotl(a, k: int):
    """Rotate left by a static 0 < k < 64."""
    return or_(shl(a, k), shr(a, 64 - k))


def _mul32_full(a, b):
    """32x32 -> 64 multiply via 16-bit limbs (no 64-bit type needed)."""
    al = a & 0xFFFF
    ah = a >> 16
    bl = b & 0xFFFF
    bh = b >> 16
    p0 = al * bl
    p1 = al * bh
    p2 = ah * bl
    p3 = ah * bh
    lo1 = p0 + (p1 << 16)
    c1 = (lo1 < p0).astype(_U32)
    lo = lo1 + (p2 << 16)
    c2 = (lo < lo1).astype(_U32)
    hi = p3 + (p1 >> 16) + (p2 >> 16) + c1 + c2
    return hi, lo


def mul(a, b):
    """Low 64 bits of a 64x64 product (the FxHash multiply)."""
    h0, l0 = _mul32_full(a[1], b[1])
    hi = h0 + a[1] * b[0] + a[0] * b[1]  # wrapping u32 adds/muls
    return (hi, l0)


def add(a, b):
    lo = a[1] + b[1]
    carry = (lo < a[1]).astype(_U32)
    return (a[0] + b[0] + carry, lo)


def eq(a, b):
    return (a[0] == b[0]) & (a[1] == b[1])


def ne(a, b):
    return (a[0] != b[0]) | (a[1] != b[1])


def lt(a, b):
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))


def le(a, b):
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] <= b[1]))


def select(pred, a, b):
    """Elementwise ``pred ? a : b``."""
    return (jnp.where(pred, a[0], b[0]), jnp.where(pred, a[1], b[1]))


def minimum(a, b):
    return select(lt(a, b), a, b)


def to_numpy(a):
    """Materialize a U64 to a host-side numpy uint64 array (for tests/IO)."""
    import numpy as np

    hi = np.asarray(a[0], dtype=np.uint64)
    lo = np.asarray(a[1], dtype=np.uint64)
    return (hi << np.uint64(32)) | lo
