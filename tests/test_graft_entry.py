"""Regression tests for the entry contract (__graft_entry__.py).

``dryrun_multichip`` once passed on the in-process 8-device CPU mesh but
failed in a fresh process that had no virtual-mesh flags ("need 8 devices,
have 1"). These tests run it the way a caller does — a clean subprocess
with no platform pinned and no device-count flags — so the entry point can
never again depend on pytest's conftest provisioning.
"""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clean_env():
    """A fresh caller's env: no platform pinned, no virtual-mesh flags
    (conftest injected both into our env; strip them back out)."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["XLA_FLAGS"] = re.sub(
        r"--xla_force_host_platform_device_count=\d+", "",
        env.get("XLA_FLAGS", ""),
    ).strip()
    return env


def _run_dryrun(n, env):
    code = (
        f"import sys; sys.path.insert(0, {REPO!r});"
        f"import __graft_entry__ as g; g.dryrun_multichip({n}); print('DRYRUN_OK')"
    )
    res = subprocess.run(
        [sys.executable, "-c", code],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, f"rc={res.returncode}\n{res.stderr[-2000:]}"
    assert "DRYRUN_OK" in res.stdout


@pytest.mark.parametrize("n", [8, 16])
def test_dryrun_multichip_driver_env(n):
    """Fresh subprocess, no platform pinned, no device-count flags. Must
    self-provision an n-device virtual CPU mesh."""
    _run_dryrun(n, _clean_env())


def test_dryrun_multichip_after_backend_init():
    """Fallback path: a process whose backend is ALREADY initialized with a
    single device must still complete (subprocess re-exec)."""
    code = (
        f"import sys, os; sys.path.insert(0, {REPO!r});"
        "os.environ['JAX_PLATFORMS']='cpu';"
        "import jax; jax.config.update('jax_platforms','cpu');"
        "assert len(jax.devices()) == 1, jax.devices();"
        "import __graft_entry__ as g; g.dryrun_multichip(8); print('DRYRUN_OK')"
    )
    env = _clean_env()
    res = subprocess.run(
        [sys.executable, "-c", code],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, f"rc={res.returncode}\n{res.stderr[-2000:]}"
    assert "DRYRUN_OK" in res.stdout
