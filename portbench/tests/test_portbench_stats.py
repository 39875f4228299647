"""The window arithmetic on a synthetic list that holds a stall."""
import pytest

from portbench import stats


def frames_with_a_stall():
    # 199 frames of 30 ms and one of 600 ms: a stall the median would hide
    return [0.030] * 150 + [0.600] + [0.030] * 49


def test_window_rate_counts_the_stall():
    t = frames_with_a_stall()
    assert stats.window_rate(sum(t), len(t)) == pytest.approx((199 * 30 + 600) / 200)


def test_p95_nearest_rank():
    t = [i / 1000 for i in range(1, 101)]  # 1..100 ms
    assert stats.percentile(t, 95) == pytest.approx(0.095)
    t = frames_with_a_stall() + [0.300] * 11
    assert stats.percentile(t, 95) == pytest.approx(0.300)


def test_no_frame_is_an_error():
    with pytest.raises(ValueError):
        stats.window_rate(1.0, 0)
