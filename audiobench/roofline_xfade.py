"""Least work of one block of a head-tracked binaural renderer that
switches every (source, ear) pair's IR and crossfades over the block, and
the least time an H100 could take for it: a frozen count beside
``roofline.py``'s, on its ``bound`` and ``stream_flops``.

A block that crossfades every pair of an n_out x n_in matrix needs the
frequency-delay-line MAC of every pair against both its outgoing and its
incoming coefficient planes (8 operations a bin and partition each), one
forward transform of 2·pts real points an input, and one inverse transform
an output and path: the inputs' spectra are shared by every output and
both paths, and the sum over inputs happens in the spectrum. Bytes count
both coefficient sets read once, the n_in input rings' windows (nparts
rows of re and im) read once, the input blocks in and the output blocks
out, and the 2·n_out overlap-add tails (an output and path) in and out, in
float32. Whatever implements the block, no gather of planes, pair copy or
rebuilt tail is counted: those are the design's, not the work's.
"""

from __future__ import annotations

from .roofline import F32, bound, stream_flops


def xfade_flops(n_in: int, n_out: int, nparts: int, pts: int) -> float:
    """Least operations of one crossfading block (bins = pts)."""
    return stream_flops(2 * n_out * n_in, nparts, pts, pts, n_in + 2 * n_out)


def xfade_bytes(n_in: int, n_out: int, nparts: int, pts: int) -> float:
    """Least bytes of that block."""
    planes_b = 2 * n_out * n_in * nparts * pts * 2 * F32
    window_b = n_in * nparts * pts * 2 * F32
    io_b = (n_in + n_out) * pts * F32
    tail_b = 2 * (2 * n_out) * pts * F32
    return planes_b + window_b + io_b + tail_b


def xfade_least_ms(n_in: int, n_out: int, nparts: int, pts: int) -> tuple[float, str]:
    """Least milliseconds of one crossfading block, and what bounds it."""
    return bound(xfade_flops(n_in, n_out, nparts, pts), xfade_bytes(n_in, n_out, nparts, pts))
