"""Vectorized 64-bit integer hashing primitives.

Bit-exact JAX re-implementations of the scalar hash pipeline the reference
applies to every canonical k-mer:

  * Thomas Wang 64-bit mix     (reference: sketch/include/sketch/hash.h:42-63)
  * canonical k-mer encoding   (reference: src/build_sketch.cpp:26-39)
  * wyhash64 stateless PRNG    (reference: sketch/include/aesctr/wy.h:41-59)

All functions are shape-polymorphic over leading batch dimensions and operate
on uint64 arrays (JAX x64 mode). The 128-bit multiply in wyhash is built from
32-bit limbs so it lowers to plain 32/64-bit ops on every backend.
"""

import numpy as np
import jax.numpy as jnp
from jax import lax

# wyhash constants (reference: sketch/include/aesctr/wy.h:56-57).
WYHASH_INC = np.uint64(0x60BEE2BEE120FC15)
WYHASH_XOR = np.uint64(0xE7037ED1A0B428DB)
# WyRand maps seed 0 -> 1337 (reference: sketch/include/aesctr/wy.h:113).
WYRAND_ZERO_SEED = np.uint64(1337)

_LO32 = np.uint64(0xFFFFFFFF)


def wang_hash64(x):
    """Thomas Wang's 64-bit integer mix (a bijection on [0, 2^64)).

    Matches sketch::WangHash::operator()(uint64_t) exactly
    (reference: sketch/include/sketch/hash.h:42-53). Only shifts/adds/xors,
    so it vectorizes cleanly.
    """
    x = jnp.asarray(x, jnp.uint64)
    x = (~x) + (x << 21)
    x = x ^ (x >> 24)
    x = (x + (x << 3)) + (x << 8)  # x * 265
    x = x ^ (x >> 14)
    x = (x + (x << 2)) + (x << 4)  # x * 21
    x = x ^ (x >> 28)
    x = x + (x << 31)
    return x


def reverse_complement(kmer, k=31):
    """Reverse complement of a 2-bit packed k-mer.

    The 2-bit code is A=0, C=1, G=2, T=3, so complement == bitwise NOT of
    each 2-bit field; the base order is reversed by a 2-bit-group bit
    reversal. Matches reference src/build_sketch.cpp:26-39.
    """
    kmer = jnp.asarray(kmer, jnp.uint64)
    x = kmer
    x = ((x >> 2) & jnp.uint64(0x3333333333333333)) | (
        (x & jnp.uint64(0x3333333333333333)) << 2
    )
    x = ((x >> 4) & jnp.uint64(0x0F0F0F0F0F0F0F0F)) | (
        (x & jnp.uint64(0x0F0F0F0F0F0F0F0F)) << 4
    )
    x = ((x >> 8) & jnp.uint64(0x00FF00FF00FF00FF)) | (
        (x & jnp.uint64(0x00FF00FF00FF00FF)) << 8
    )
    x = ((x >> 16) & jnp.uint64(0x0000FFFF0000FFFF)) | (
        (x & jnp.uint64(0x0000FFFF0000FFFF)) << 16
    )
    x = (x >> 32) | (x << 32)
    return (~x) >> (64 - (k << 1))


def canonical_kmer(kmer, k=31):
    """min(kmer, reverse_complement(kmer)) - strand-independent k-mer key."""
    kmer = jnp.asarray(kmer, jnp.uint64)
    rev = reverse_complement(kmer, k)
    return jnp.minimum(kmer, rev)


def umul128_fold(a, b):
    """(a * b) mod 2^64  XOR  (a * b) >> 64, via 32-bit limbs.

    This is wyhash's _wymum mixing step (reference:
    sketch/include/aesctr/wy.h:45-49). The high 64 bits of the 128-bit
    product are assembled from four 32x32->64 partial products, all of which
    are exact in uint64.
    """
    a = jnp.asarray(a, jnp.uint64)
    b = jnp.asarray(b, jnp.uint64)
    a0 = a & _LO32
    a1 = a >> 32
    b0 = b & _LO32
    b1 = b >> 32
    t = a0 * b0
    carry = t >> 32
    t1 = a1 * b0 + carry
    t2 = a0 * b1 + (t1 & _LO32)
    hi = a1 * b1 + (t1 >> 32) + (t2 >> 32)
    lo = a * b  # wraps mod 2^64
    return hi ^ lo


def wyrand_draws(seed, n_draws):
    """The first `n_draws` 64-bit outputs of WyRand for each seed.

    WyRand's state is a pure additive counter (state += WYHASH_INC per draw),
    so draws are independent and computable in parallel:

        draw_j = _wymum((s0 + (j+1)*INC) ^ XOR, s0 + (j+1)*INC)

    A seed of 0 maps to 1337 (reference: sketch/include/aesctr/wy.h:113).
    With WyHash<uint32_t, 1>, each 64-bit draw serves two 32-bit gen() calls:
    first the LOW 32 bits, then the HIGH 32 bits (little-endian buffering,
    reference: sketch/include/aesctr/wy.h:133-142).

    Args:
      seed: uint64 array (...,) of seeds.
      n_draws: static int, number of 64-bit draws per seed.

    Returns:
      uint64 array (..., n_draws).
    """
    seed = jnp.asarray(seed, jnp.uint64)
    s0 = jnp.where(seed == 0, WYRAND_ZERO_SEED, seed)
    j = (jnp.arange(1, n_draws + 1, dtype=jnp.uint64) * WYHASH_INC).reshape(
        (1,) * seed.ndim + (n_draws,)
    )
    states = s0[..., None] + j
    return umul128_fold(states ^ WYHASH_XOR, states)


def clz64(x):
    """Count leading zeros of uint64 values (clz(0) == 64)."""
    return lax.clz(jnp.asarray(x, jnp.uint64)).astype(jnp.uint32)
