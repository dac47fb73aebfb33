"""Vectorized canonical k-mer extraction from 2-bit base-code streams.

The reference scans each FASTA record base-by-base with a rolling 2k-bit
window, resetting the window at non-ACGT characters and record boundaries
(reference: src/build_sketch.cpp:62-92). That streaming formulation is
equivalent to:

    a k-mer ending at position i is valid  <=>  codes[i-k+1 .. i] are all
    valid bases with no reset sentinel in between,

    kmer[i] = sum_{t=0..k-1} codes[i-t] << (2*t)

which is how we compute it here: k shifted adds over the whole stream (pure
elementwise work) plus a cumulative-sum validity check, instead of a sequential scan.

Input encoding (produced by utils.fasta / the native reader):
  0..3   = A,C,G,T (case-insensitive already folded)
  >= 4   = reset sentinel (non-ACGT base, or record boundary)

The scanner's "invalid character shifts a 0 into the window" detail of the
reference is immaterial: windows containing a reset are never emitted, and
any emitted window is fully overwritten by >= k valid bases.
"""

from functools import partial

import jax
import jax.numpy as jnp

from .hashes import canonical_kmer


@partial(jax.jit, static_argnames=("k",))
def kmer_windows(codes, k=31):
    """All k-length windows of a code stream, with validity mask.

    Args:
      codes: uint8 array (L,) of base codes (>=4 marks a reset).
      k: static k-mer length (<= 32).

    Returns:
      (kmers, valid): uint64 (L,) packed windows ending at each position, and
      bool (L,) marking positions whose whole window is valid. Positions
      i < k-1 are always invalid.
    """
    codes = jnp.asarray(codes, jnp.uint8)
    length = codes.shape[0]
    ok = codes < 4
    c64 = jnp.where(ok, codes, 0).astype(jnp.uint64)

    # kmer[i] = sum_t c64[i-t] << (2t); out-of-range reads are zero-padded.
    padded = jnp.concatenate([jnp.zeros(k - 1, jnp.uint64), c64])
    acc = jnp.zeros(length, jnp.uint64)
    for t in range(k):
        acc = acc | (jax.lax.dynamic_slice(padded, (k - 1 - t,), (length,)) << (2 * t))

    bad = (~ok).astype(jnp.int32)
    cbad = jnp.cumsum(bad)
    # window [i-k+1, i] has no bad base <=> cbad[i] - cbad[i-k] == 0
    cbad_shift = jnp.concatenate([jnp.zeros(k, jnp.int32), cbad])[:length]
    valid = (cbad - cbad_shift) == 0
    valid = valid & (jnp.arange(length) >= k - 1)
    return acc, valid


@partial(jax.jit, static_argnames=("k",))
def canonical_kmers(codes, k=31):
    """Canonical (strand-independent) k-mers of a code stream + validity."""
    kms, valid = kmer_windows(codes, k)
    return canonical_kmer(kms, k), valid


def canonical_kmers_np(codes, k=31):
    """Host-side convenience: compacted numpy array of valid canonical k-mers."""
    import numpy as np

    kms, valid = canonical_kmers(jnp.asarray(codes), k)
    return np.asarray(kms)[np.asarray(valid)]
