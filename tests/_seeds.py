"""Rotating-seed policy for the differential suites .

Fixed seeds make "bit-exact on random inputs" claims only as strong as
the 5 samples that chose the tolerance. Policy:

- ``RUSTCV_DIFF_SEED`` unset  -> seed base derived from today's date
  (UTC, YYYYMMDD): every day's run samples FRESH inputs, so tolerance
  envelopes are continuously re-confirmed instead of frozen in 2026.
- ``RUSTCV_DIFF_SEED=pin``    -> the historical pinned set (exact
  reproduction of the recorded r3/r4 evidence runs).
- ``RUSTCV_DIFF_SEED=<int>``  -> that base (reproduce a failed rotated
  run: every assertion message includes the failing seed).

The wide-sweep tests (``-m widesweep``, deselected by default via
addopts) run 50 seeds over the estimate-based tolerance envelopes
(warp/remap/hull) once per round on the chip host.
"""
from __future__ import annotations

import datetime
import os

PINNED = [0, 1, 2, 7, 42]


def seed_base() -> int | None:
    """None means 'use the pinned set'."""
    v = os.environ.get("RUSTCV_DIFF_SEED", "")
    if v == "pin":
        return None
    if v:
        return int(v)
    return int(datetime.datetime.now(datetime.timezone.utc)
               .strftime("%Y%m%d"))


def diff_seeds(n: int = 5) -> list[int]:
    base = seed_base()
    if base is None:
        return PINNED[:n] + PINNED[: max(0, n - len(PINNED))]
    return [base + i for i in range(n)]
