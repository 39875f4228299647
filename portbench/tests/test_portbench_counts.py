"""counts.py against chip_smoke.py's bounds at 800x800."""
import pytest

from portbench import counts


def test_k4_bound_by_bytes_at_800():
    # chip_smoke.py phase 3: K4's bound 0.0298 ms, by bytes, on 800x800,
    # every input read for every pixel
    ms, by = counts.k4_bound(800 * 800, non_sky=800 * 800, failed=2_000, fallback=5_000)
    assert by == "bytes"
    assert ms == pytest.approx(0.0298, abs=5e-5)


def test_k4_sky_pixels_read_less():
    # a sky pixel reads 10 floats and writes 11: a frame of 10% geometry
    ms, by = counts.k4_bound(800 * 800, non_sky=64_000, failed=0, fallback=0)
    assert by == "bytes"
    assert ms == pytest.approx((64_000 * 39 + 576_000 * 21) * 4 / 3.35e12 * 1e3)


def test_k5_bound_by_operations_on_the_test_scene():
    # chip_smoke.py phase 4: K5's chain of 5, bound 0.0224 ms by operations,
    # on the test scene's frame (53% of 640,000 pixels not sky)
    ms, by = counts.k5_bound(800 * 800, non_sky=340_700, iterations=5)
    assert by == "operations"
    assert ms == pytest.approx(0.0224, abs=5e-5)


def test_k5_bound_by_bytes_on_a_sky_frame():
    ms, by = counts.k5_bound(800 * 800, non_sky=64_000, iterations=5)
    assert by == "bytes"
    assert ms == pytest.approx(800 * 800 * 17 * 4 / 3.35e12 * 1e3)
