"""QR codes: GF/RS correctness, encode→matrix-decode across versions/
levels/masks, image-level detect+decode under rotation, perspective,
and noise."""

import random

import numpy as np
import pytest

from rustcv_tpu.ops import qr, warp


class TestReedSolomon:
    def test_clean_roundtrip(self):
        cw = qr.rs_encode(list(range(10, 29)), 7)
        assert qr.rs_correct(cw, 7) == cw

    def test_corrects_up_to_t_errors(self):
        cw = qr.rs_encode(list(range(10, 29)), 7)
        rnd = random.Random(0)
        for nerr in (1, 2, 3):
            for _ in range(10):
                bad = list(cw)
                for p in rnd.sample(range(len(cw)), nerr):
                    bad[p] ^= rnd.randint(1, 255)
                assert qr.rs_correct(bad, 7) == cw

    def test_rejects_beyond_t(self):
        cw = qr.rs_encode(list(range(10, 29)), 7)
        bad = list(cw)
        for i in range(4):
            bad[2 * i] ^= 0x77
        assert qr.rs_correct(bad, 7) is None

    def test_large_block(self):
        cw = qr.rs_encode(list(range(1, 81)), 20)
        bad = list(cw)
        for p in (0, 13, 29, 55, 77, 90, 95, 99):
            bad[p] ^= 0xA5
        assert qr.rs_correct(bad, 20) == cw


class TestMatrix:
    @pytest.mark.parametrize("v,lvl,mask,text", [
        (1, "L", 0, "HELLO"), (1, "H", 6, "x"),
        (2, "M", 3, "rustcv_tpu round three"),
        (3, "Q", 2, "abcdefghij klmnop"),
        (4, "H", 7, "QR on GPU frameworks!"),
    ])
    def test_encode_decode_roundtrip(self, v, lvl, mask, text):
        m = qr.encode(text, v, lvl, mask)
        assert m.shape == (17 + 4 * v,) * 2
        assert qr.decode_matrix(m) == text

    def test_capacity_guard(self):
        with pytest.raises(ValueError):
            qr.encode("x" * 100, 1, "H")

    def test_module_damage_corrected(self):
        m = qr.encode("DAMAGE TEST", 2, "H", 1)
        bad = m.copy()
        # flip a few data modules: v2-H corrects 14 byte errors and
        # each flipped module can hit a distinct byte, so stay under 14
        rng = np.random.default_rng(3)
        coords = qr._data_coords(2)
        for i in rng.choice(len(coords), 10, replace=False):
            r, c = coords[i]
            bad[r, c] = not bad[r, c]
        assert qr.decode_matrix(bad) == "DAMAGE TEST"


def _canvas(img, pad=20, bg=255):
    c = np.full((img.shape[0] + 2 * pad, img.shape[1] + 2 * pad), bg,
                np.uint8)
    c[pad:pad + img.shape[0], pad:pad + img.shape[1]] = img
    return c


class TestDetect:
    @pytest.mark.parametrize("v", [1, 2, 3, 4])
    def test_versions(self, v):
        text = f"v{v} data!"  # short enough for v1-M capacity
        img = qr.draw(qr.encode(text, v, "M", 2), 4, 4)
        out, quad = qr.detect_and_decode(_canvas(img))
        assert out == text and quad is not None and quad.shape == (4, 2)

    @pytest.mark.parametrize("k", [0, 1, 2, 3])
    def test_rotations(self, k):
        img = qr.draw(qr.encode("ROTATE ME", 2, "L", 1), 4, 4)
        out, _ = qr.detect_and_decode(_canvas(np.rot90(img, k)))
        assert out == "ROTATE ME"

    def test_perspective(self):
        img = qr.draw(qr.encode("PERSPECTIVE", 2, "Q", 4), 6, 4)
        s = img.shape[0]
        srcq = np.array([[0, 0], [s - 1, 0], [s - 1, s - 1], [0, s - 1]],
                        float)
        dstq = np.array([[40, 35], [250, 50], [245, 250], [35, 240]],
                        float)
        hmat = warp.get_perspective_transform(srcq, dstq)
        wimg = warp.warp_perspective_numpy(img[..., None], hmat,
                                           (300, 300))[..., 0]
        mask = warp.warp_perspective_numpy(
            np.full_like(img, 255)[..., None], hmat, (300, 300))[..., 0]
        canvas = np.full((300, 300), 255, np.uint8)
        canvas[mask > 128] = wimg[mask > 128]
        out, _ = qr.detect_and_decode(canvas)
        assert out == "PERSPECTIVE"

    def test_noise(self):
        rng = np.random.default_rng(0)
        img = qr.draw(qr.encode("NOISY CHANNEL", 2, "H", 3), 5, 4)
        canvas = _canvas(img, bg=245)
        noisy = np.clip(canvas.astype(int)
                        + rng.normal(0, 25, canvas.shape), 0,
                        255).astype(np.uint8)
        out, _ = qr.detect_and_decode(noisy)
        assert out == "NOISY CHANNEL"

    def test_plain_scene_none(self):
        rng = np.random.default_rng(5)
        noise = rng.integers(0, 256, (160, 200)).astype(np.uint8)
        out, quad = qr.detect_and_decode(noise)
        assert out is None and quad is None
