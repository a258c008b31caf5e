"""Least work of a convolution-matrix scan, and the least time an H100
could take for it: a frozen count beside ``roofline.py``'s, on its
``bound`` and ``stream_flops``.

An n_out x n_in matrix of partitioned IRs needs, a block, the
frequency-delay-line MAC of every (out, in) pair (8 operations a bin and
partition), one forward transform of 2·pts real points an input and one
inverse transform an output: the inputs' spectra are shared by every
output, and the sum over inputs happens in the spectrum. Bytes count the
IR matrix's spectra read once, the n_in input rings' windows (nparts rows
of re and im) in and out, the input blocks in and the output blocks out,
and the n_out overlap-add tails in and out, in float32.
"""

from __future__ import annotations

from .roofline import F32, bound, stream_flops


def matrix_flops(n_in: int, n_out: int, blocks: int, nparts: int, pts: int) -> float:
    """Least operations of one scan of ``blocks`` blocks (bins = pts)."""
    return stream_flops(n_out * n_in * blocks, nparts, pts, pts, (n_in + n_out) * blocks)


def matrix_bytes(n_in: int, n_out: int, blocks: int, nparts: int, pts: int) -> float:
    """Least bytes of that scan."""
    irs_b = n_out * n_in * nparts * pts * 2 * F32
    ring_b = n_in * nparts * pts * 2 * F32
    io_b = (n_in + n_out) * blocks * pts * F32
    tail_b = n_out * pts * F32
    return irs_b + 2 * ring_b + io_b + 2 * tail_b


def matrix_least_ms(n_in: int, n_out: int, blocks: int, nparts: int, pts: int
                    ) -> tuple[float, str]:
    """Least milliseconds of one matrix scan, and what bounds it."""
    return bound(matrix_flops(n_in, n_out, blocks, nparts, pts),
                 matrix_bytes(n_in, n_out, blocks, nparts, pts))
