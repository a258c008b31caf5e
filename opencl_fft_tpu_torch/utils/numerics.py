"""Numeric helpers shared across the framework.

``np2`` — next power of two, reference ``csound/opcode.cpp:30-35`` (the
reference returns at least 2 and rounds *up to or equal*).
"""

from __future__ import annotations


def np2(n: int) -> int:
    """Next power of two >= n (minimum 2). Parity with csound/opcode.cpp:30-35."""
    v = 2
    while v < n:
        v <<= 1
    return v


def is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0
