"""Floating-point exactness helpers.

XLA contracts a multiply feeding an add into an FMA (one rounding instead
of two), on the CPU and on the GPU alike, which silently changes f64
results vs the reference's scalar C++ (verified: the ERTL-MLE secant
updates diverge by 1 ulp under jit). `jax.lax.optimization_barrier` does
NOT reliably survive to codegen (XLA removes barriers before fusion), so
`rounded` forces an explicit rounding point with `nextafter(v, v)` - an
IEEE identity (returns v exactly for every input) that the compiler must
evaluate, severing the mul->add contraction.

Regression coverage: tests/test_estimators.py::test_mle_bit_exact_vs_oracle
fails within 1 ulp if contraction re-appears on the CPU; the device
ERTL-MLE phase of chip_smoke.py checks the same bit-exactness on the GPU.
"""

import jax.numpy as jnp


def rounded(x):
    """Force x to round to its IEEE value before use (blocks FMA fusion)."""
    return jnp.nextafter(x, x)
