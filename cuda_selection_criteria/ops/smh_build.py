"""Batched SuperMinHash bucket construction (order-independent reformulation).

The reference's SuperMinHash (Ertl) processes items sequentially with a
data-dependent early-exit loop (reference: sketch/include/sketch/bbmh.h:639-670):
for item `x` it seeds WyRand with `x`, then for j = 0..a_ draws
(k_j, r_j), maintains a lazily-reset Fisher-Yates permutation p via
swap(p[k_j], p[j]), and min-updates h[p[j]] with the candidate
(j << 32) | r_j. The bound a_ (tracked via the b_ histogram) only skips
candidates that provably cannot win:

    a_ = max_b min(m-1, h[b] >> 32), so j > a_  =>  for every bucket b,
    j > h[b] >> 32  =>  (j << 32 | r) > h[b]  =>  no update.

Therefore the final sketch is exactly

    h[b] = min over items x and j in [0, m) with sigma_x(j) = b
               of (j << 32) | r_j(x)

where sigma_x is the Fisher-Yates permutation prefix of item x - a pure
min-reduce over independent per-item candidates. Items commute, batches
merge by element-wise min, and the whole build parallelizes with zero
sequential state. Bit-exactness vs. the reference is proven in
tests/test_smh.py against the committed .smh4/.smh64 files.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .hashes import wyrand_draws

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


@partial(jax.jit, static_argnames=("m",))
def smh_candidates(kmers, valid, m):
    """Per-item SuperMinHash candidates and their target buckets.

    Args:
      kmers: uint64 (T,) canonical k-mers (the WyRand seeds; seed 0 -> 1337).
      valid: bool (T,) mask; invalid items yield candidates of U64_MAX.
      m: static bucket count (power of two; SizePow2Policy semantics).

    Returns:
      (buckets, cands): int32 (T, m) bucket index sigma_x(j), and
      uint64 (T, m) candidate values (j << 32) | r_j.
    """
    t = kmers.shape[0]
    mask = jnp.uint64(m - 1)
    draws = wyrand_draws(kmers, m)  # (T, m); one 64-bit draw per j
    # gen() call order per j: low 32 bits -> k, high 32 bits -> r
    # (reference: sketch/include/aesctr/wy.h:133-142, bbmh.h:650,657).
    k = (draws & mask).astype(jnp.int32)  # mod is "& (m-1)" (policy.h:21-23)
    r = draws >> 32

    # Fisher-Yates prefix, vectorized across items: p starts as identity
    # (the reference's lazy q_/i_ reset makes p fresh per item). The j loop
    # is a lax.fori_loop so the trace stays O(1) in m - a Python unroll at
    # m=512 costs minutes of compile time for identical math.
    perm0 = jnp.broadcast_to(jnp.arange(m, dtype=jnp.int32), (t, m))
    iota = jnp.arange(m, dtype=jnp.int32)
    buckets0 = jnp.zeros((t, m), jnp.int32)

    def body(j, carry):
        perm, buckets = carry
        kj = jax.lax.dynamic_index_in_dim(k, j, axis=1, keepdims=False)
        vj = jax.lax.dynamic_index_in_dim(perm, j, axis=1, keepdims=False)
        vk = jnp.take_along_axis(perm, kj[:, None], axis=1)[:, 0]
        # swap(p[k], p[j]): p[j] <- old p[k]; p[k] <- old p[j].
        perm = jax.lax.dynamic_update_slice_in_dim(
            perm, vk[:, None], j, axis=1
        )
        perm = jnp.where(iota[None, :] == kj[:, None], vj[:, None], perm)
        # after the swap, the candidate goes to bucket p[j] == vk
        # (when kj == j the second write restores vj == vk, consistent).
        bj = jnp.where(kj == j, vj, vk)
        buckets = jax.lax.dynamic_update_slice_in_dim(
            buckets, bj[:, None], j, axis=1
        )
        return perm, buckets

    _, buckets = jax.lax.fori_loop(0, m, body, (perm0, buckets0))

    j64 = jnp.arange(m, dtype=jnp.uint64) << 32
    cands = jnp.where(valid[:, None], j64[None, :] | r, U64_MAX)
    return buckets, cands


@partial(jax.jit, static_argnames=("m", "n_genomes"))
def smh_build_batch_full(kmers, valid, genome_ids, m, n_genomes):
    """Build SuperMinHash h_ vectors for a batch of genomes in one reduce.

    Returns uint64 (n_genomes, m); empty buckets remain U64_MAX, matching the
    reference's h_ initialization (bbmh.h:567).
    """
    buckets, cands = smh_candidates(kmers, valid, m)
    seg = genome_ids[:, None] * m + buckets  # (T, m)
    h = jax.ops.segment_min(
        cands.reshape(-1),
        seg.reshape(-1).astype(jnp.int32),
        num_segments=n_genomes * m,
    )
    return h.reshape(n_genomes, m)


@partial(jax.jit, static_argnames=("m", "n_genomes"))
def smh_build_batch_j0(kmers, valid, genome_ids, m, n_genomes):
    """The j=0-only SuperMinHash pass: exact whenever it is complete.

    The first candidate of item x lands in bucket k_0 = low32(draw_0) & (m-1)
    with value (0 << 32) | r_0 = high32(draw_0) < 2^32 (sigma_x(0) = k_0: the
    first Fisher-Yates swap puts p[0] = k_0 - no permutation state needed).
    Every j >= 1 candidate is >= 2^32, so if every bucket of a genome
    received some j=0 candidate, the j=0 minima ARE the exact h_ - the
    batch analog of the reference's a_-bound, which also degenerates to
    j = 0 once every bucket holds a small candidate (bbmh.h:639-670).

    Returns (h, complete): uint64 (n_genomes, m) and a bool scalar; `h` is
    the exact sketch iff `complete` (max over all buckets < 2^32).
    """
    draws = wyrand_draws(jnp.asarray(kmers, jnp.uint64), 1)[..., 0]  # (T,)
    k0 = (draws & jnp.uint64(m - 1)).astype(jnp.int32)
    # j=0 candidate values are r0 < 2^32: run the scatter-min in NATIVE
    # int32 via the order-preserving bias r ^ 0x8000_0000 (u64 scatters are
    # emulated and ~10x slower). INT32_MAX doubles as the empty marker; a
    # genuine r0 == 0xffffffff winner collides with it, maps to U64_MAX,
    # fails the completeness check, and takes the exact full path - so the
    # collision costs time, never correctness.
    biased = ((draws >> 32).astype(jnp.uint32)
              ^ jnp.uint32(0x80000000)).astype(jnp.int32)
    i32_max = jnp.int32(0x7FFFFFFF)
    gids = jnp.asarray(genome_ids, jnp.int32)
    seg = (gids * m + k0).astype(jnp.int32)
    vals = jnp.where(valid, biased, i32_max)
    n_seg = n_genomes * m

    if n_seg <= 256:
        # Few segments -> a scatter-min serializes on index collisions
        # (~400 ms/M items); a dense masked min over (chunk, n_seg) tiles
        # is pure elementwise work instead (~10x faster).
        tc = max(128, (1 << 23) // n_seg)
        t = vals.shape[0]
        n_chunks = -(-t // tc)
        pad = n_chunks * tc - t
        v_p = jnp.pad(vals, (0, pad), constant_values=0x7FFFFFFF)
        s_p = jnp.pad(seg, (0, pad), constant_values=0).reshape(n_chunks, tc)
        v_p = v_p.reshape(n_chunks, tc)
        ids = jnp.arange(n_seg, dtype=jnp.int32)

        def chunk_min(carry, xs):
            bv, sv = xs
            mins = jnp.min(
                jnp.where(sv[:, None] == ids[None, :], bv[:, None], i32_max),
                axis=0,
            )
            return jnp.minimum(carry, mins), None

        h32, _ = jax.lax.scan(
            chunk_min, jnp.full(n_seg, i32_max, jnp.int32), (v_p, s_p)
        )
        h32 = h32.reshape(n_genomes, m)
    else:
        # Collision splitting: scatters serialize on duplicate indices,
        # so spread each segment over K interleaved sub-slots (collisions
        # drop ~Kx) and fold the sub-slots with one dense min.
        t = vals.shape[0]
        k_split = int(np.clip(t // max(1, n_seg), 1, 256))
        sub = (
            jnp.arange(t, dtype=jnp.int32) % k_split
            if k_split > 1 else jnp.zeros(t, jnp.int32)
        )
        part = jax.ops.segment_min(
            vals, seg * k_split + sub, num_segments=n_seg * k_split,
        )
        h32 = jnp.min(
            part.reshape(n_seg, k_split), axis=1
        ).reshape(n_genomes, m)
    h = jnp.where(
        h32 == i32_max,
        U64_MAX,
        (h32.astype(jnp.uint32) ^ jnp.uint32(0x80000000)).astype(jnp.uint64),
    )
    # A genome is exactly covered if every bucket got a j=0 winner, OR it
    # has no items at all (its exact h_ is all-U64_MAX either way - this
    # keeps padded slots of packed multi-genome builds from forcing the
    # slow path).
    g_ok = (jnp.max(h, axis=1) < jnp.uint64(1) << 32) | (
        jnp.min(h, axis=1) == U64_MAX
    )
    return h, jnp.all(g_ok)


def smh_build_batch(kmers, valid, genome_ids, m, n_genomes):
    """Exact batched SuperMinHash build with the j=0 fast path.

    Runs the one-draw segment-min first (O(T) work, no Fisher-Yates); a
    single scalar fetch verifies completeness, and only batches where some
    genome has a j=0-empty bucket (tiny genomes: P ~ m*(1-1/m)^T) fall
    back to the full candidate simulation. Both paths are bit-exact vs the
    reference (tests/test_smh.py).
    """
    h, complete = smh_build_batch_j0(kmers, valid, genome_ids, m, n_genomes)
    if bool(complete):
        return h
    return smh_build_batch_full(kmers, valid, genome_ids, m, n_genomes)


def smh_merge_min(h_a, h_b):
    """Element-wise min merge: combining batches == one sequential build."""
    return jnp.minimum(h_a, h_b)


@partial(jax.jit, static_argnames=("m",))
def smh_update(h, kmers, valid, m):
    """Fold a new k-mer batch into an existing single-genome h_ vector."""
    batch = smh_build_batch_full(
        kmers, valid, jnp.zeros(kmers.shape, jnp.int32), m, 1
    )[0]
    return jnp.minimum(h, batch)
