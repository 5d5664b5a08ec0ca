"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device hardware isn't available in CI, so sharding is tested on a
virtual CPU mesh. Env vars must be set before jax is imported anywhere.
Set ``RUSTCV_TEST_DEVICE=1`` to run on the machine's accelerator instead
(single process; ``chip_smoke.py`` runs the ``gpu``-marked tests that way).
"""

import os

# Tests must not pop OS windows or couple to the window system: force the
# headless highgui sink regardless of DISPLAY. The dedicated GUI test
# re-enables the SDL path in a subprocess with RUSTCV_GUI=dummy.
os.environ["RUSTCV_GUI"] = "0"

_ON_DEVICE = os.environ.get("RUSTCV_TEST_DEVICE") == "1"

if not _ON_DEVICE:
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture()
def rng():
    """Function-scoped on purpose: a session-scoped generator made every
    test's data depend on how many other tests drew from it first
    (order-dependent flakes, e.g. test_knn_index_exact vs approximate
    FLANN). Each test now sees the same deterministic stream regardless
    of which subset of the suite runs."""
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def jax_cpu():
    """jax on the test backend (virtual CPU mesh by default; the machine's
    accelerator when RUSTCV_TEST_DEVICE=1 — the name is historical)."""
    import jax

    if not _ON_DEVICE:
        assert jax.default_backend() == "cpu"
    return jax


@pytest.fixture()
def gpu():
    """jax on an NVIDIA GPU; skips the test elsewhere (``gpu``-marked tests
    compile kernels that have no CPU lowering)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: python chip_smoke.py)")
    return jax
