"""HyperLogLog sketch model (device-built, reference-format compatible).

Capability parity with sketch::hll_t as exercised by the reference
(construct/addh/report/union_size/write/read - sketch/include/sketch/hll.h),
with construction running as batched device scatters (ops.hll_build) and
estimation as batched ERTL-MLE (ops.estimators).
"""

import numpy as np
import jax.numpy as jnp

from ..ops import hll_build, estimators, pairwise, kmers as kmer_ops
from ..utils import formats


class HllSketch:
    """One genome's HLL register array at precision p (2^p uint8 registers)."""

    def __init__(self, p, core=None):
        self.p = int(p)
        if core is None:
            core = np.zeros(1 << self.p, np.uint8)
        core = np.asarray(core, np.uint8)
        if core.size != (1 << self.p):
            raise ValueError("register count does not match precision")
        self.core = core
        self._card = None

    # -- construction ------------------------------------------------------
    @classmethod
    def from_kmers(cls, kmer_arr, p, valid=None):
        """Build from already-canonical uint64 k-mers (device scatter)."""
        kmer_arr = jnp.asarray(kmer_arr, jnp.uint64)
        if valid is None:
            valid = jnp.ones(kmer_arr.shape, bool)
        regs = hll_build.hll_build_batch(
            kmer_arr, valid, jnp.zeros(kmer_arr.shape, jnp.int32), p, 1
        )[0]
        return cls(p, np.asarray(regs))

    @classmethod
    def from_codes(cls, codes, p, k=31):
        """Build from a 2-bit base-code stream (utils.fasta encoding)."""
        kms, valid = kmer_ops.canonical_kmers(jnp.asarray(codes), k)
        regs = hll_build.hll_build_batch(
            kms, valid, jnp.zeros(kms.shape, jnp.int32), p, 1
        )[0]
        return cls(p, np.asarray(regs))

    @classmethod
    def from_file(cls, path):
        p, core, _ = formats.read_hll(path)
        return cls(p, core)

    # -- reference API parity ---------------------------------------------
    def report(self):
        """ERTL-MLE cardinality estimate (reference: hll.h:834-864)."""
        if self._card is None:
            self._card = float(estimators.ertl_mle_from_regs(jnp.asarray(self.core), self.p))
        return self._card

    def union_size(self, other):
        """Union cardinality with another sketch (reference: hll.h:1188-1210)."""
        if self.p != other.p:
            raise ValueError("precision mismatch")
        t = pairwise.union_cardinality(
            jnp.asarray(self.core)[None, :], jnp.asarray(other.core)[None, :], self.p
        )
        return float(t[0, 0])

    def jaccard(self, other):
        t = self.union_size(other)
        e1, e2 = int(self.report()), int(other.report())
        return (e1 + e2 - t) / t

    def merge(self, other):
        """Union sketch: element-wise register max."""
        return HllSketch(self.p, np.maximum(self.core, other.core))

    def write(self, path):
        formats.write_hll(path, self.p, self.core)

    def __eq__(self, other):
        return self.p == other.p and np.array_equal(self.core, other.core)
