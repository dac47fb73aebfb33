"""cuda_selection_criteria - a GPU sketch-based genomic similarity engine.

Finds all pairs of genomes with Jaccard similarity >= tau among a set of gzipped
FASTA files using probabilistic sketches (HyperLogLog + SuperMinHash), with the
all-pairs selection stage running as tiled int8 tensor-core reductions on the
GPU via JAX / XLA / Pallas.

Capability parity target: sanhue903/CUDA_Selection_Criteria (C++/OpenMP/CUDA).
This is a ground-up design, not a port:

  * HLL register construction  -> batched hash + segment-max scatter (device)
  * SuperMinHash bucket update -> reformulated as an order-independent
    min-reduce over per-item Fisher-Yates candidates (bit-exact equivalent of
    the sequential reference algorithm, proven in tests/test_smh.py), so the
    whole sketch build is embarrassingly parallel.
  * Pairwise HLL union statistics -> CDF-indicator matmuls:
    #{r : max(a_r,b_r) <= v} = sum_r [a_r<=v]*[b_r<=v], one (Bi,R)x(R,Bj)
    int8 contraction per register value v, instead of per-pair scalar loops.
  * ERTL-MLE cardinality estimation -> batched, masked secant iteration in f64
    (bit-identical to the reference's hll.h:629-688 scalar loop).
  * Multi-device scaling -> jax.sharding.Mesh over a ("rows",) axis: tiles
    sharded over replicated banks, or the bank itself sharded with a ring.

64-bit integers (canonical k-mers, WangHash, WyRand) and f64 estimators are
required for bit-exactness with the reference, so importing this package
enables JAX x64 mode.
"""

import os as _os

import jax as _jax

_jax.config.update("jax_enable_x64", True)

# Large numpy temporaries (bank sort/pad, exact-confirm register scans)
# must REUSE freed arena pages: on lazily-restored micro-VM hosts,
# first-touch page faults on fresh mmaps run ~60x slower than reuse.
# Same spirit as the x64 flip above: process-wide, required for the
# package to perform as designed. See utils/hostmem.py for the numbers.
from .utils.hostmem import enable_arena_reuse as _enable_arena_reuse  # noqa: E402

_enable_arena_reuse()

# Persistent compile cache used when JAX_COMPILATION_CACHE_DIR is unset: one
# fixed directory inside the checkout (listed in .gitignore), so repeated
# runs from the same checkout find their compiled kernels again.
DEFAULT_COMPILE_CACHE = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def enable_compile_cache():
    """Persistent compilation cache for accelerator backends.

    The screen kernel recompiles per (tile size, present-value set) and
    real banks each have their own value set, so caching makes repeat CLI
    invocations start hot. JAX reads JAX_COMPILATION_CACHE_DIR itself;
    only when it is unset is the in-checkout default set here. CPU is
    excluded: XLA:CPU AOT artifacts are machine-feature-specific and can
    SIGILL when a cache written on one host is loaded on another. Called
    by the CLIs, bench.py and chip_smoke.py at startup.
    """
    if _jax.default_backend() == "cpu":
        return
    if "JAX_COMPILATION_CACHE_DIR" not in _os.environ:
        _jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


__version__ = "0.1.0"

from . import ops, models, parallel, utils  # noqa: E402,F401
