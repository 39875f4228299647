"""The port's copy of the image-comparison utilities
(tpuray_torch/utils/imgcmp.py) against tpuray.utils.imgcmp on seeded
images: the same numpy code, so every result is exactly equal."""
import numpy as np
import pytest

import tpuray.utils.imgcmp as jimg
import tpuray_torch.utils.imgcmp as img


def _images():
    rng = np.random.default_rng(21)
    yy, xx = np.meshgrid(np.arange(72), np.arange(80), indexing="ij")
    base = np.sin(xx * 0.31) * np.cos(yy * 0.17) + 0.2 * rng.standard_normal((72, 80))
    a = ((base - base.min()) / np.ptp(base)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    rgb = rng.random((72, 80, 3)).astype(np.float32)
    return a, b, rgb


CASES = {
    "luminance": lambda m, a, b, rgb: m.luminance(rgb),
    "ssim_r3": lambda m, a, b, rgb: m.ssim(a, b),
    "ssim_r1": lambda m, a, b, rgb: m.ssim(a, b, radius=1, dynamic_range=2.0),
    "grad_mag": lambda m, a, b, rgb: m.grad_mag(a),
    "ncc": lambda m, a, b, rgb: m.ncc(a, b),
    "best_offset": lambda m, a, b, rgb: m.best_offset(a[13:13 + 40, 6:6 + 48], a, search=24),
}


@pytest.mark.parametrize("name", list(CASES))
def test_matches_tpuray(name):
    a, b, rgb = _images()
    got = CASES[name](img, a, b, rgb)
    want = CASES[name](jimg, a, b, rgb)
    if name == "best_offset":
        assert got == want and got[0] == (13, 6)
    else:
        np.testing.assert_array_equal(got, want)
