"""Wall-clock timing with device synchronization.

The reference's TIMERSTART/TIMERSTOP chrono macros (include/metrictime2.hpp:9-17)
print `label: N.XXXs`; its CUDA variant forgot to synchronize before stopping
(experiments/src/time_smh_cuda.cpp:279-283). Here timed regions always call
jax.block_until_ready on their results, so device timings measure
execution, not dispatch.
"""

import contextlib
import time

import jax


class Timer:
    def __init__(self, label):
        self.label = label
        self.seconds = None
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False

    def csv_row(self):
        return f"# elapsed time ({self.label}): {self.seconds:.3f}s"


@contextlib.contextmanager
def device_timer(label, results_holder=None):
    """Times a region; call holder.sync(x) on device outputs inside to ensure
    they complete before the clock stops."""
    t = Timer(label)

    class _Holder:
        def sync(self, x):
            jax.block_until_ready(x)
            return x

    h = _Holder()
    t0 = time.perf_counter()
    yield h, t
    t.seconds = time.perf_counter() - t0
    if results_holder is not None:
        results_holder[label] = t.seconds
