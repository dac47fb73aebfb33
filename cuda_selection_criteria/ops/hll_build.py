"""Batched HyperLogLog register construction.

The reference updates one register per hashed k-mer with a compare-and-swap
max loop (reference: sketch/include/sketch/hll.h:886-899):

    index = hash >> (64 - p)
    rank  = clz(((hash << 1) | 1) << (p - 1)) + 1
    core[index] = max(core[index], rank)

Max is associative/commutative and idempotent, so on device the whole build is
a single segment-max scatter over a batch of hashed k-mers - no atomics, no
races, deterministic by construction.
"""

from functools import partial

import jax
import jax.numpy as jnp

from .hashes import wang_hash64, clz64


@partial(jax.jit, static_argnames=("p",))
def hll_index_rank(hashed, p):
    """(register index, rank) for 64-bit hash values at precision p."""
    hashed = jnp.asarray(hashed, jnp.uint64)
    idx = (hashed >> (64 - p)).astype(jnp.int32)
    rank = (clz64(((hashed << 1) | jnp.uint64(1)) << (p - 1)) + 1).astype(jnp.int32)
    return idx, rank


@partial(jax.jit, static_argnames=("p", "n_genomes"))
def hll_build_batch(kmers, valid, genome_ids, p, n_genomes):
    """Build HLL register banks for a batch of genomes in one scatter.

    Args:
      kmers: uint64 (M,) canonical k-mers (pre-hash).
      valid: bool (M,) mask; invalid positions contribute nothing.
      genome_ids: int32 (M,) genome index per k-mer in [0, n_genomes).
      p: static HLL precision (2^p registers/genome).
      n_genomes: static number of genomes in the batch.

    Returns:
      uint8 (n_genomes, 2^p) register bank.
    """
    m = 1 << p
    hashed = wang_hash64(kmers)
    idx, rank = hll_index_rank(hashed, p)
    # Invalid slots go to a scrap segment at the end.
    flat_idx = jnp.where(valid, genome_ids * m + idx, n_genomes * m)
    regs = jax.ops.segment_max(
        rank,
        flat_idx,
        num_segments=n_genomes * m + 1,
        indices_are_sorted=False,
        unique_indices=False,
    )
    # Empty segments come back as the dtype minimum; registers start at 0.
    regs = jnp.maximum(regs[: n_genomes * m], 0).astype(jnp.uint8)
    return regs.reshape(n_genomes, m)


def hll_merge_max(core_a, core_b):
    """Element-wise max merge of two register banks (union sketch)."""
    return jnp.maximum(core_a, core_b)


@partial(jax.jit, static_argnames=("p",))
def hll_update(core, kmers, valid, p):
    """Fold a new batch of k-mers into an existing single-genome register set.

    Enables streaming construction for genomes larger than one device batch:
    max-merge of per-batch banks equals the sequential build.
    """
    batch = hll_build_batch(kmers, valid, jnp.zeros(kmers.shape, jnp.int32), p, 1)[0]
    return jnp.maximum(core, batch)
