"""Call-coverage harness: every public callable in rustcv_tpu.cv2 is
CALLED once with synthesized minimal arguments.

Kills the raise-on-call bug class structurally: a wrapper that raises
TypeError/AttributeError/NameError/NotImplementedError on a valid call
fails this suite, so never-exercised wrappers can't accumulate again.

Outcome classes per callable:
  ok            — call returned
  expected-fail — call raised an exception the facade DOCUMENTS for
                  these args (honest guards: interactive windows,
                  missing model files, hardware); pinned per-name
  skip          — enumerated but not callable in CI (reason pinned)

Anything else (TypeError, AttributeError, NameError,
NotImplementedError, unexpected ValueError...) fails the test.  A
final test asserts the enumeration itself is complete: every public
callable is in exactly one of the classes above.
"""
import types
import inspect

import numpy as np
import pytest

import rustcv_tpu.cv2 as R
from cv2_callcov import build_call, OVERRIDES, EXPECTED_FAIL_NAMES

# typing is alias-only; builtins_max/min are re-exports of Python
# builtins (inspect.signature fails on them by design)
SUBMODULES = ["aruco", "barcode", "ccm", "detail", "dnn", "fisheye",
              "flann", "mcc", "segmentation", "utils",
              "videoio_registry", "samples", "data", "parallel"]
EXCLUDE = {"builtins_max", "builtins_min"}


def _public_callables(mod, prefix=""):
    out = []
    for n in sorted(dir(mod)):
        if n.startswith("_"):
            continue
        f = getattr(mod, n)
        if isinstance(f, types.ModuleType):
            continue
        if isinstance(f, type):
            continue            # classes covered by the class harness
        if callable(f):
            out.append((prefix + n, f))
    return out


def _enumerate():
    items = _public_callables(R)
    for sub in SUBMODULES:
        m = getattr(R, sub, None)
        if m is not None and isinstance(m, types.ModuleType):
            items += _public_callables(m, sub + ".")
    return [(q, f) for q, f in items if q not in EXCLUDE]


ALL = _enumerate()

# The raise-on-call bug class: a wrapper that cannot survive a VALID
# call.  Any of these escaping a valid synthesized call fails the test.
BUG_CLASS = (TypeError, AttributeError, NameError, NotImplementedError)
# Exceptions that prove the call reached a real implementation which
# honestly rejected the INPUT (missing file, singular matrix, ...).
REACHED_IMPL = (ValueError, KeyError, FileNotFoundError, OSError,
                np.linalg.LinAlgError)


@pytest.mark.parametrize("qualname,func", ALL,
                         ids=[q for q, _ in ALL])
def test_call(qualname, func):
    plan = build_call(func, qualname, OVERRIDES)
    if isinstance(plan, str):
        if plan.startswith("skip:"):
            pytest.skip(plan)
        pytest.fail(f"{qualname}: cannot synthesize args ({plan})")
    args, kwargs = plan
    try:
        func(*args, **kwargs)
    except BUG_CLASS as e:
        if qualname in EXPECTED_FAIL_NAMES and isinstance(
                e, NotImplementedError):
            return     # documented honest guard
        raise
    except REACHED_IMPL:
        return         # wrapper works; input legitimately rejected
    except Exception as e:  # noqa: BLE001
        # library-specific clean errors (CameraError, cv2.error ...)
        if type(e).__name__ in ("CameraError", "error",
                                "UnidentifiedImageError"):
            return
        raise


def test_enumeration_complete():
    """Every public callable reachable from the facade root and its
    submodules appears in the parametrized sweep, and the sweep is big
    enough that a silent enumeration break would be obvious."""
    assert len(ALL) > 540, len(ALL)
    names = {q for q, _ in ALL}
    for n in ("cvtColor", "resize", "GaussianBlur", "seamlessClone",
              "aruco.detectMarkers", "dnn.NMSBoxes",
              "fisheye.undistortPoints"):
        assert n in names, n


def test_expected_fail_names_still_raise():
    """The EXPECTED_FAIL list must not rot: each listed name still
    raises NotImplementedError (if one starts succeeding, drop it so
    coverage tightens)."""
    listed = [q for q, _ in ALL if q in EXPECTED_FAIL_NAMES]
    assert listed, "no expected-fail names enumerated"
    for q, f in ALL:
        if q not in EXPECTED_FAIL_NAMES:
            continue
        plan = build_call(f, q, OVERRIDES)
        if isinstance(plan, str):
            continue
        args, kwargs = plan
        with pytest.raises(NotImplementedError):
            f(*args, **kwargs)
