"""Multi-process ``jax.distributed`` rehearsal.

The only seam between the virtual-mesh evidence and a real pod is process
boundaries: does the global mesh form across ``jax.distributed.initialize``
processes, and does the fleet psum actually cross them?  This test launches
TWO OS processes × 4 virtual CPU devices each against a localhost
coordinator and asserts

  * both processes see chips == 8 (global mesh formed: 2 procs × 4 local),
  * fleet_fps ≈ 2 × local_fps (the psum summed contributions from BOTH
    processes — a same-process reduction would return 1 × local_fps).

Reference seam: SURVEY.md §2.7 scale-out row; examples/launch_distributed.py
is the turnkey pod script being rehearsed.
"""

import ast
import json
import os
import socket
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_fleet_psum():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["RUSTCV_GUI"] = "0"
    env["PYTHONPATH"] = _REPO
    coord = f"127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, "examples/launch_distributed.py",
             "--coordinator", coord, "--num-processes", "2",
             "--process-id", str(pid), "--streams-per-chip", "1",
             "--width", "128", "--height", "96", "--ticks", "3",
             "--platform", "cpu"],
            env=env, cwd=_REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"process failed rc={rc}\n{out[-2000:]}\n{err[-4000:]}"
    # process 0 prints the summary dict
    line = next(l for l in outs[0][1].splitlines() if l.startswith("{"))
    rec = ast.literal_eval(line)
    assert rec["processes"] == 2
    assert rec["chips"] == 8, "global mesh did not aggregate both processes"
    # the fleet psum must have crossed processes: 2x the local rate
    # (identical work per process; generous band for CPU timing noise)
    ratio = rec["fleet_fps"] / rec["local_fps"]
    assert 1.5 < ratio < 2.5, f"fleet/local ratio {ratio} — psum local only?"


@pytest.mark.slow
def test_four_process_2d_mesh_bit_exact():
    """4 processes x 4 devices = a 16-device virtual fleet
    running the 2-D streams x rows program (ppermute halo exchange) with
    the device grid transposed so EVERY row-band neighbor lives in a
    different process — the halos must cross process boundaries for the
    result to be bit-exact vs the golden integer chain."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["RUSTCV_GUI"] = "0"
    env["PYTHONPATH"] = _REPO
    coord = f"127.0.0.1:{_free_port()}"
    n_proc = 4
    procs = [
        subprocess.Popen(
            [sys.executable, "examples/rehearse_2d_distributed.py",
             "--coordinator", coord, "--num-processes", str(n_proc),
             "--process-id", str(pid), "--platform", "cpu"],
            env=env, cwd=_REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(n_proc)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        outs.append((p.returncode, out, err))
    recs = []
    for rc, out, err in outs:
        assert rc == 0, f"process failed rc={rc}\n{out[-2000:]}\n{err[-4000:]}"
        line = next(l for l in out.splitlines() if l.startswith("{"))
        recs.append(json.loads(line))
    for rec in recs:
        assert rec["chips"] == 16, "global mesh did not form 4x4"
        assert rec["mesh"] == [4, 4]
        assert rec["bit_exact"] is True
        assert rec["shards_checked"] == 4  # one band per stream per process
    # interior bands consumed 2 cross-process halos each, edge bands 1:
    # per process = 4 streams x (1 or 2); fleet total = 4 streams x 3
    # edges x 2 directions = 24
    assert sum(r["cross_process_halo_edges"] for r in recs) == 24
