"""Numeric helpers shared across the framework.

``np2`` — next power of two, reference ``csound/opcode.cpp:30-35`` (the
reference returns at least 2 and rounds *up to or equal*).
``bit_reverse_indices`` — the bit-reversal permutation table of
``cl_fft.cpp:96-101`` (kept for parity tests; the port's FFTs are
self-sorting). ``exact_matmul`` — the one route of the package's matrix
products (``ops/fft.py``).
"""

from __future__ import annotations

import numpy as np
import torch


def np2(n: int) -> int:
    """Next power of two >= n (minimum 2). Parity with csound/opcode.cpp:30-35."""
    v = 2
    while v < n:
        v <<= 1
    return v


def is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def ilog2(n: int) -> int:
    """log2 of a power of two; ValueError for anything else."""
    if not is_pow2(n):
        raise ValueError(f"size must be a power of two, got {n}")
    return n.bit_length() - 1


def bit_reverse_indices(n: int) -> np.ndarray:
    """Bit-reversed index table (int32), built as cl_fft.cpp:96-101 builds
    it; ValueError unless n is a power of two."""
    if not is_pow2(n):
        raise ValueError(f"size must be a power of two, got {n}")
    bp = np.zeros(n, dtype=np.int32)
    i = 1
    half = n // 2
    while i < n:
        bp[i:2 * i] = bp[:i] + half
        i <<= 1
        half >>= 1
    return bp


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with full float32 accuracy, whatever torch's process-wide
    matmul settings say (``torch.set_float32_matmul_precision``,
    ``torch.backends.cuda.matmul.allow_tf32``, the ``fp32_precision``
    flags), which would otherwise let cuBLAS use TF32 and the CPU bf16.

    A float32 ``a`` is widened to float64, multiplied by ``b`` in float64
    and the product rounded to float32 once: a float64 product is outside
    every float32 precision setting, so the helper reads and sets no global
    flag. It leaves the caller's settings as they were and changes nothing
    for a concurrent thread's products (no set-and-restore, no lock). Each
    float32 entry is the rounded float64 dot product, at least as exact as
    a float32 GEMM at full precision. ``b`` is float32, or a constant
    table's exact float64 widening built once a device (``fwd_table(...,
    torch.float64)``), so that only ``a`` is widened a call. Float64
    operands (the float64 configs) multiply as given."""
    if a.dtype == torch.float32 and b.dtype in (torch.float32, torch.float64):
        return torch.matmul(a.double(), b.double()).float()
    return torch.matmul(a, b)
