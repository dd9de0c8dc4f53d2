"""The frozen work counts against hand counts at tiny shapes."""

import pytest

from benchmark import workcount as W

VIEW = dict(points=10, pixels=512, tiles=2, entries=30, entry_points=8, blended=1000)


def test_entry_bytes_by_hand():
    # ranges 2 x 2 ints, 30 ids, 8 rows of 9 floats: (4 + 30 + 72) * 4 bytes.
    assert W.entry_bytes(2, 30, 8) == (4 + 30 + 72) * 4


def test_stage_counts_by_hand():
    s = W.stages(VIEW)
    assert s["rasterize_forward"] == ((4 + 30 + 72) * 4 + 512 * 5 * 4, 17_000)
    assert s["rasterize_backward"] == ((4 + 30 + 72) * 4 + 512 * 5 * 4 + 30 * 9 * 4, 17_000)
    assert s["adam"] == (10 * 59 * 7 * 4, 10 * 59 * 12)
    assert s["projection"] == (10 * (59 + 9 + 3) * 4, 10 * 306)
    assert s["loss"] == (512 * 9 * 4, 512 * 1_400)
    assert s["reduce"] == (30 * 10 * 4 + 10 * 9 * 4, 30 * 9)


def test_bound_takes_the_larger():
    assert W.bound_ms(3.35e12, 0) == pytest.approx(1e3)
    assert W.bound_ms(0, 67e12) == pytest.approx(1e3)
    assert W.bound_ms(3.35e9, 67e12) == pytest.approx(1e3)


def test_least_time_sums_the_stages():
    s = W.stages(VIEW)
    assert W.least_ms(VIEW) == pytest.approx(sum(W.bound_ms(*v) for v in s.values()))
    assert W.least_ms(VIEW, W.SERVE_STAGES) == pytest.approx(
        sum(W.bound_ms(*s[n]) for n in W.SERVE_STAGES))
    assert W.mean_view([VIEW, dict(VIEW, points=30)])["points"] == 20
