"""Batched sequence/kmer statistics.

``gc_count_u64`` is the array-plane version of the reference's
specialized 2-bit GC popcount (/root/reference/src/counting.jl:1-8):
per 64-bit register, ``popcount((w ^ (w >> 1)) & 0x5555...)`` — C=01 and
G=10 differ in their two bits, A=00 and T=11 do not.  Popcount is built
from the classic SWAR ladder in uint32 lanes (no popcount primitive needed).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["popcount32", "gc_count_u64", "gc_fraction_windows"]

_U32 = jnp.uint32


def popcount32(x):
    m1 = jnp.asarray(0x55555555, _U32)
    m2 = jnp.asarray(0x33333333, _U32)
    m4 = jnp.asarray(0x0F0F0F0F, _U32)
    x = x - ((x >> 1) & m1)
    x = (x & m2) + ((x >> 2) & m2)
    x = (x + (x >> 4)) & m4
    return (x * jnp.asarray(0x01010101, _U32)) >> 24


@jax.jit
def gc_count_u64(hi, lo):
    """Per-register GC symbol count for 2-bit kmer registers."""
    m = jnp.asarray(0x55555555, _U32)
    return popcount32((hi ^ (hi >> 1)) & m) + popcount32((lo ^ (lo >> 1)) & m)


@jax.jit
def gc_fraction_windows(hi, lo, K: int | None = None):
    """GC fraction per window; K defaults from nothing — pass K for the
    denominator, else returns raw counts as float divided by 1."""
    c = gc_count_u64(hi, lo).astype(jnp.float32)
    if K:
        c = c / K
    return c
