"""Least work of a partitioned-convolution scan, and the least time an H100
could take for it.

A frozen copy of the arithmetic of ``chip_smoke.py`` (``bound``,
``rfft_flops``, ``stream_flops`` and the byte counts of its serving
phase), kept here so that a change to the program cannot move the
yardstick. It counts the least work, not what a kernel's design does: the
frequency-delay-line MAC at 8 operations a bin, partition and block of a
channel (one complex multiply-add), and one real transform of 2·pts
points, 2.5·n·log2 n operations, for each forward and inverse transform a
block needs (two for LTI, three for TV). Bytes count each input and state
byte read once and each output byte written once.
"""

from __future__ import annotations

import math

# H100 SXM published peaks at its full 700 W limit: FP32 outside the
# tensor cores (the scans run plain FP32 FMA) and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
F32 = 4


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least milliseconds the card could take: the larger of the FLOPs over
    the FP32 peak and the bytes over the HBM rate; and which of the two."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rfft_flops(n: int) -> float:
    """Operations of one transform of n real points: half those of a
    complex one, 5 n log2 n."""
    return 2.5 * n * math.log2(n)


def stream_flops(nb: int, nparts: int, bins: int, pts: int, transforms: int) -> float:
    """Least operations of a partitioned scan of nb channel-blocks: the FDL
    MAC (8 operations per bin, partition and block) and ``transforms`` real
    transforms of 2*pts points."""
    return 8.0 * nb * nparts * bins + transforms * rfft_flops(2 * pts)


def scan_flops(channels: int, blocks: int, nparts: int, pts: int, tv: bool) -> float:
    """Least operations of one scan of ``blocks`` blocks on ``channels``
    channels: two transforms a channel-block for LTI, three for TV."""
    nbc = channels * blocks
    return stream_flops(nbc, nparts, pts, pts, (3 if tv else 2) * nbc)


def scan_bytes(channels: int, blocks: int, nparts: int, pts: int, tv: bool) -> float:
    """Least bytes of that scan (float32): the input blocks in and the
    output out; the input ring's window (nparts rows of re and im) and the
    overlap-add tail in and out; the coefficient ring in (LTI), or in and
    out beside the second operand's blocks in (TV)."""
    blocks_b = channels * blocks * pts * F32
    ring_b = channels * nparts * pts * 2 * F32
    tail_b = channels * pts * F32
    if tv:
        return 2 * (blocks_b + ring_b + ring_b + tail_b) + blocks_b
    return 2 * (blocks_b + ring_b + tail_b) + ring_b


def scan_least_ms(channels: int, blocks: int, nparts: int, pts: int, tv: bool
                  ) -> tuple[float, str]:
    """Least milliseconds of one scan, and what bounds it."""
    return bound(scan_flops(channels, blocks, nparts, pts, tv),
                 scan_bytes(channels, blocks, nparts, pts, tv))
