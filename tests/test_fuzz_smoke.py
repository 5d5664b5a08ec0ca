"""CI wiring for the fuzz harnesses.

Runs both fuzzers with a small bounded budget inside the suite so the
robustness posture is continuously exercised, not a dev-time anecdote:

- the ASan+UBSan native JPEG fuzzer replays the full pinned corpus
  (regression pass) plus a short seeded mutation loop; any sanitizer
  report is a nonzero exit;
- the AVI mutational fuzzer (pure-Python parser of untrusted bytes)
  runs its unmutated regression pass plus a seeded mutation budget.

The long-budget runs remain ``make fuzz`` (FUZZ_SECONDS=60 default).
"""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "tests", "fuzz", "corpus")

BUDGET = os.environ.get("RUSTCV_FUZZ_SMOKE_SECONDS", "3")


def test_corpus_pinned():
    names = sorted(os.listdir(CORPUS))
    # the corpus is a regression artifact: losing files silently would
    # hollow out the replay pass
    assert len(names) >= 8, names
    assert "pil_restart.jpg" in names and "sim_q85.jpg" in names


@pytest.mark.slow
def test_fuzz_jpeg_asan_smoke(tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++")
    exe = str(tmp_path / "rcv_fuzz_jpeg")
    build = subprocess.run(
        [gxx, "-O1", "-g", "-std=c++17",
         "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
         os.path.join(REPO, "rustcv_tpu/native/jpeg_entropy.cpp"),
         os.path.join(REPO, "rustcv_tpu/native/jpeg_encode.cpp"),
         os.path.join(REPO, "tests/fuzz/fuzz_jpeg.cpp"),
         "-o", exe],
        capture_output=True, text=True, timeout=300)
    assert build.returncode == 0, build.stderr[-2000:]
    run = subprocess.run([exe, CORPUS, BUDGET], capture_output=True,
                         text=True, timeout=240)
    assert run.returncode == 0, (run.stdout[-1000:], run.stderr[-3000:])


@pytest.mark.slow
def test_fuzz_avi_smoke():
    run = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests/fuzz/fuzz_avi.py"),
         BUDGET],
        capture_output=True, text=True, timeout=240,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert run.returncode == 0, (run.stdout[-1000:], run.stderr[-3000:])
    assert "clean" in run.stdout
