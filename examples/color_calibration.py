"""Color calibration end-to-end: render a Macbeth-style chart through
a color cast, detect it, fit a color-correction matrix, apply it, and
verify the cast is removed — all on this framework's own primitives.

Run: python examples/color_calibration.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rustcv_tpu.ops import colorchecker as cc  # noqa: E402
from rustcv_tpu.ops.core_ops import apply_ccm  # noqa: E402


def render_chart(cast=None, shape=(300, 420)):
    img = np.full((*shape, 3), 190, np.uint8)
    x0, y0, cw, chh, sep, frame = 60, 50, 48, 44, 6, 10
    w_total = 6 * cw + 7 * sep
    h_total = 4 * chh + 5 * sep
    img[y0 - frame:y0 + h_total + frame,
        x0 - frame:x0 + w_total + frame] = 20
    img[y0:y0 + h_total, x0:x0 + w_total] = 250
    colors = cc.REFERENCE_SRGB.copy()
    if cast is not None:
        colors = np.clip((colors / 255.0) @ np.asarray(cast).T,
                         0, 1) * 255.0
    for r in range(4):
        for c in range(6):
            y = y0 + sep + r * (chh + sep)
            x = x0 + sep + c * (cw + sep)
            img[y:y + chh, x:x + cw] = colors[r * 6 + c][::-1]
    return img


def main() -> int:
    # a warm cast: red boosted, blue sapped
    cast = np.array([[1.1, 0.08, 0.0],
                     [0.05, 0.95, 0.03],
                     [0.0, 0.05, 0.75]])
    img = render_chart(cast)
    out = cc.detect_color_checker(img)
    if out is None:
        print("chart not found")
        return 1
    corners, colors = out
    print(f"chart found at {corners[0].round(1)}..{corners[2].round(1)}")

    before = np.abs(colors - cc.REFERENCE_SRGB[:, ::-1])
    m = cc.color_checker_ccm(colors)
    src_rgb = np.asarray(colors)[:, ::-1] / 255.0
    corrected = apply_ccm(src_rgb.reshape(4, 6, 3), m).reshape(-1, 3)
    after = np.abs(corrected * 255.0 - cc.REFERENCE_SRGB)
    print(f"patch error: median {np.median(before):.1f} → "
          f"{np.median(after):.2f} (LSB)")

    # apply to the full image and re-measure
    full = apply_ccm(img[..., ::-1].astype(np.float64) / 255.0, m)
    full_bgr = np.clip(np.rint(full[..., ::-1] * 255), 0,
                       255).astype(np.uint8)
    out2 = cc.detect_color_checker(full_bgr)
    ok = out2 is not None
    if ok:
        _, colors2 = out2
        resid = np.median(np.abs(colors2 - cc.REFERENCE_SRGB[:, ::-1]))
        print(f"full-image correction residual: {resid:.2f} LSB")
        ok = resid < 6 and np.median(after) < 5
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
