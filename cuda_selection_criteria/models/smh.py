"""SuperMinHash sketch model (device-built, reference-format compatible).

Capability parity with sketch::SuperMinHash<> as exercised by the reference
(construct/addh/h_ vector/serialization - sketch/include/sketch/bbmh.h:531-755),
built via the order-independent min-reduce formulation (ops.smh_build).
"""

import numpy as np
import jax.numpy as jnp

from ..ops import smh_build, kmers as kmer_ops
from ..utils import formats

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def vecsize(arg):
    """SizePow2Policy::arg2vecsize: next power of two of arg
    (reference: sketch/include/sketch/policy.h:15-19)."""
    arg = int(arg)
    if arg <= 1:
        return 1
    n = 1 << (arg - 1).bit_length()
    return n


class SuperMinHashSketch:
    """One genome's SuperMinHash bucket vector h_ (m uint64 buckets)."""

    def __init__(self, m, h=None):
        self.m = vecsize(m)
        if h is None:
            h = np.full(self.m, U64_MAX, np.uint64)
        h = np.asarray(h, np.uint64)
        if h.size != self.m:
            raise ValueError("bucket count mismatch")
        self.h = h

    @classmethod
    def from_kmers(cls, kmer_arr, m, valid=None):
        kmer_arr = jnp.asarray(kmer_arr, jnp.uint64)
        if valid is None:
            valid = jnp.ones(kmer_arr.shape, bool)
        mv = vecsize(m)
        h = smh_build.smh_build_batch(
            kmer_arr, valid, jnp.zeros(kmer_arr.shape, jnp.int32), mv, 1
        )[0]
        return cls(mv, np.asarray(h))

    @classmethod
    def from_codes(cls, codes, m, k=31):
        kms, valid = kmer_ops.canonical_kmers(jnp.asarray(codes), k)
        return cls.from_kmers(kms, m, valid)

    @classmethod
    def from_file(cls, path):
        h = formats.read_smh(path)
        return cls(h.size, h)

    def merge(self, other):
        """Combining two streams == element-wise bucket min."""
        return SuperMinHashSketch(self.m, np.minimum(self.h, other.h))

    def write(self, path):
        formats.write_smh(path, self.h)

    def __eq__(self, other):
        return self.m == other.m and np.array_equal(self.h, other.h)
