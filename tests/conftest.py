"""Test configuration: force an 8-device virtual CPU mesh before JAX loads.

Tests run on the CPU (the reference has no distributed layer to fake -
SURVEY.md section 4): multi-device sharding paths are validated on
virtual CPU devices. What needs the GPU carries the `gpu` marker and
skips here; `python chip_smoke.py` runs it on the card.
"""

import os
import sys

import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Checkout of the reference project (its influenza corpus, committed
# sketches and results.txt); golden tests skip when it is not given.
REFERENCE = os.environ.get("CSC_REFERENCE", "")


def reference_available():
    return bool(REFERENCE) and os.path.isdir(REFERENCE)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time,
    never at import, so every test worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU; chip_smoke.py runs this on the card")
