"""The frozen least-work count, pinned to the bounds the port's kernel table
reports and to the TV cell's scan."""

import pytest

from audiobench import roofline


@pytest.mark.parametrize("channels, blocks, tv, gflop, ms", [
    (64, 470, False, 33.081, 0.4938),
    (64, 470, True, 33.851, 0.5052),
    (1, 1880, False, 2.068, 0.0309),
    (1, 1880, True, 2.116, 0.0316),
])
def test_headline_bounds(channels, blocks, tv, gflop, ms):
    flops = roofline.scan_flops(channels, blocks, 256, 512, tv)
    least, what = roofline.scan_least_ms(channels, blocks, 256, 512, tv)
    assert flops / 1e9 == pytest.approx(gflop, abs=5e-4)
    assert least == pytest.approx(ms, abs=5e-5)
    assert what == "operations"


def test_tv_2p22_scan():
    """512 blocks of one channel at nparts 512, bins 8192: 17.180 GFLOP of
    MAC and 0.881 of three 16,384-point transforms a block."""
    mac = 8.0 * 512 * 512 * 8192
    assert mac / 1e9 == pytest.approx(17.180, abs=5e-4)
    assert 3 * 512 * roofline.rfft_flops(16384) / 1e9 == pytest.approx(0.881, abs=5e-4)
    assert roofline.scan_flops(1, 512, 512, 8192, True) / 1e9 == pytest.approx(18.061, abs=5e-4)
    least, what = roofline.scan_least_ms(1, 512, 512, 8192, True)
    assert least == pytest.approx(0.2696, abs=5e-5) and what == "operations"


def test_bytes_bound_when_flops_are_few():
    least, what = roofline.bound(0.0, 3.35e9)
    assert (least, what) == (pytest.approx(1.0), "bytes")
