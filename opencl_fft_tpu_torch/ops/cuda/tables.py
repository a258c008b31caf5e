"""Fused transform tables of the streaming engine, built in float64 numpy
and rounded once to float32 — copies of the JAX package's builders in
``ops/pallas/blockstep.py`` and ``ops/pallas/splitstep.py`` (bit for bit:
the tests compare them).

``_wfwd_np(pts)``: block @ W == the whole forward rFFT of the zero-padded
frame (deinterleave + half-size DFT + pack), split [re | im].
``_wpost_np(bins)``: [accr | acci] @ W == [time[:bins] | time[bins:]], the
whole inverse half (unpack + inverse DFT + deinterleave).
``_coef_stacks_np(m)``: the pack and unpack of both chains as two (8, m)
coefficient stacks, which the whole-scan kernels (``ops/cuda/streamstep.py``)
apply around m-point FFTs in place of the dense tables (6 m^2 floats).

``unpack_twiddle(bins)``: the inverse unpack's twiddle exp(+i pi k / bins)
(``rfft._half_twiddle_np(bins, +1)``), which ``block_mac_unpack`` reads.

The ``*_table``/``*_tables`` functions and ``unpack_twiddle`` cache the
float32 tensors per (size, device).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..rfft import _half_twiddle_np


@functools.lru_cache(maxsize=None)
def _pack_matrix_np(m: int, forward: bool) -> np.ndarray:
    """(2m, 2m) matrix U with [re | im] @ U == the pack_forward
    (forward=True) or unpack_inverse (False) of the split spectrum: both
    passes are linear in (re, im), so each folds into one matrix."""
    i = np.arange(m, dtype=np.float64)
    sign = -1.0 if forward else +1.0
    w = np.exp(sign * 1j * np.pi * i / m)
    dr, di = np.diag(w.real), np.diag(w.imag)
    eye = np.eye(m)
    p = np.zeros((m, m))
    p[(-np.arange(m)) % m, np.arange(m)] = 1.0
    if forward:
        a_rr = 0.5 * (eye + p) - 0.5 * (p - eye) @ di
        a_ir = 0.5 * (p + eye) @ dr
        a_ri = 0.5 * (p - eye) @ dr
        a_ii = 0.5 * (eye - p) + 0.5 * (p + eye) @ di
    else:
        a_rr = 0.5 * (eye + p) - 0.5 * (eye - p) @ di
        a_ir = -0.5 * (eye + p) @ dr
        a_ri = 0.5 * (eye - p) @ dr
        a_ii = 0.5 * (eye - p) - 0.5 * (eye + p) @ di
    u = np.block([[a_rr, a_ri], [a_ir, a_ii]])
    # special output bins are column replacements
    b0 = 0.5 if forward else 1.0
    u[:, 0] = 0.0
    u[:, m] = 0.0
    u[0, 0] = b0                          # outr[0] = b0*(re0 + im0)
    u[m, 0] = b0
    u[0, m] = b0                          # outi[0] = b0*(re0 - im0)
    u[m, m] = -b0
    u[:, m // 2] = 0.0
    u[:, m + m // 2] = 0.0
    u[m // 2, m // 2] = 1.0               # untouched conjugate bin
    u[m + m // 2, m + m // 2] = 1.0
    return u


@functools.lru_cache(maxsize=None)
def _wfwd_np(pts: int) -> np.ndarray:
    """(pts, 2m) forward table: row-selected DFT @ pack matrix, in f64."""
    m = pts
    jk = np.outer(np.arange(m, dtype=np.float64), np.arange(m, dtype=np.float64))
    w = np.exp(-2j * np.pi * jk / m)
    blockm = np.block([[w.real, w.imag], [-w.imag, w.real]])   # (2m, 2m) f64
    f = np.zeros((pts, 2 * m))
    k = np.arange(pts)
    f[k % 2 == 0] = blockm[(k[k % 2 == 0]) // 2]
    f[k % 2 == 1] = blockm[m + (k[k % 2 == 1] - 1) // 2]
    return (f @ _pack_matrix_np(m, True)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _wpost_np(bins: int) -> np.ndarray:
    """(2m, 2m) inverse table: unpack @ inverse DFT @ deinterleave, in f64."""
    m = bins
    jk = np.outer(np.arange(m, dtype=np.float64), np.arange(m, dtype=np.float64))
    w = np.exp(+2j * np.pi * jk / m)
    winv = np.block([[w.real, w.imag], [-w.imag, w.real]])     # (2m, 2m) f64
    m1, m2 = _deinterleave_np(m)
    sel = np.concatenate([m1, m2], axis=1).astype(np.float64)  # (2m, 2m)
    return (_pack_matrix_np(m, False) @ winv @ sel).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _deinterleave_np(b: int):
    """One-hot (2b, b) matrices M1/M2 with [Yre Yim] @ M1 = time[:b] and
    @ M2 = time[b:], where time[2i] = Yre[i], time[2i+1] = Yim[i]."""
    m1 = np.zeros((2 * b, b), np.float32)
    m2 = np.zeros((2 * b, b), np.float32)
    for i in range(b // 2):
        m1[i, 2 * i] = 1.0
        m1[b + i, 2 * i + 1] = 1.0
    for i in range(b // 2, b):
        m2[i, 2 * (i - b // 2)] = 1.0
        m2[b + i, 2 * (i - b // 2) + 1] = 1.0
    return m1, m2


@functools.lru_cache(maxsize=None)
def fwd_table(pts: int, device: torch.device,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``_wfwd_np(pts)`` (float32 values) as a ``dtype`` tensor on
    ``device``; float64 is the exact widening that ``exact_matmul`` takes,
    built once a device."""
    return torch.from_numpy(_wfwd_np(pts)).to(device, dtype)


@functools.lru_cache(maxsize=None)
def post_table(bins: int, device: torch.device,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``_wpost_np(bins)`` (float32 values) as a ``dtype`` tensor on
    ``device``, as ``fwd_table``."""
    return torch.from_numpy(_wpost_np(bins)).to(device, dtype)


@functools.lru_cache(maxsize=None)
def unpack_twiddle(bins: int, device: torch.device):
    """exp(+i pi k / bins), k < bins, built in float64 and rounded once to
    float32 (the twiddle of ``rfft.unpack_inverse``), as split (re, im)
    tensors on ``device``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(p)).to(device)
                 for p in _half_twiddle_np(bins, +1))


@functools.lru_cache(maxsize=None)
def pack_coeffs_np(m: int, forward: bool):
    """The pack (forward) or unpack pass [re | im] @ U of ``_pack_matrix_np``
    as 8 length-m float64 vectors: out_re = re*a1 + nflip(re)*a2 + im*b1 +
    nflip(im)*b2, out_im = re*c1 + nflip(re)*c2 + im*d1 + nflip(im)*d2,
    nflip the index negation v_k -> v_{(m-k) % m}; returned as ((a1, a2),
    (b1, b2), (c1, c2), (d1, d2)), the blocks U[:m, :m], U[m:, :m],
    U[:m, m:] and U[m:, m:] each as diag(x1) + nflip @ diag(x2).

    Built in O(m) from the matrix's formulas, bit for bit what the JAX
    package gets from the dense (2m, 2m) matrix (a product by a diagonal
    has one nonzero term an entry): e and p are the diagonal and flip
    cells' entries of I and of the flip, and at k = 0 and m/2, where the two
    cells coincide, the matrix's column replacements hold and x2 = 0."""
    i = np.arange(m, dtype=np.float64)
    w = np.exp((-1.0 if forward else +1.0) * 1j * np.pi * i / m)
    dr, di = w.real, w.imag

    def blocks(e, p):
        if forward:
            return (0.5 * (e + p) - 0.5 * (p - e) * di, 0.5 * (p + e) * dr,
                    0.5 * (p - e) * dr, 0.5 * (e - p) + 0.5 * (p + e) * di)
        return (0.5 * (e + p) - 0.5 * (e - p) * di, -0.5 * (e + p) * dr,
                0.5 * (e - p) * dr, 0.5 * (e - p) - 0.5 * (e + p) * di)

    b0 = 0.5 if forward else 1.0
    special = ((b0, 1.0), (b0, 0.0), (b0, 0.0), (-b0, 1.0))   # bins 0 and m/2
    out = []
    for x1, x2, (s0, sh) in zip(blocks(1.0, 0.0), blocks(0.0, 1.0), special):
        x1, x2 = x1.copy(), x2.copy()
        x1[0], x1[m // 2] = s0, sh
        x2[0] = x2[m // 2] = 0.0
        out.append((x1, x2))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _coef_stacks_np(m: int):
    """(8, m) forward and (8, m) inverse coefficient stacks, float32.

    Forward rows [a1, a2, b1, b2, c1, c2, d1, d2]: with (Zr, Zi) the
    half-size DFT of the frame and Fr/Fi the same index-negated (the JAX
    chain's FR, FI and GR, GI), packed_re = Zr*a1 + Fr*a2 + Zi*b1 + Fi*b2
    and packed_im = Zr*c1 + Fr*c2 + Zi*d1 + Fi*d2.
    Inverse rows [a1, b1, na2, nb2, c1, d1, nc2, nd2] (n* index-negated):
    A = accR*a1 + accI*b1, B = accR*na2 + accI*nb2, D = accR*c1 + accI*d1,
    E = accR*nc2 + accI*nd2, and the unpacked spectrum is (A + nflip(B),
    D + nflip(E))."""
    (fa1, fa2), (fb1, fb2), (fc1, fc2), (fd1, fd2) = pack_coeffs_np(m, True)
    fwd = np.stack([fa1, fa2, fb1, fb2, fc1, fc2, fd1, fd2]).astype(np.float32)
    (ia1, ia2), (ib1, ib2), (ic1, ic2), (id1, id2) = pack_coeffs_np(m, False)

    def nf(v):
        return np.roll(v[::-1], 1)

    inv = np.stack([ia1, ib1, nf(ia2), nf(ib2),
                    ic1, id1, nf(ic2), nf(id2)]).astype(np.float32)
    return fwd, inv


@functools.lru_cache(maxsize=None)
def coef_tables(m: int, device: torch.device):
    """(forward, inverse) coefficient stacks ``_coef_stacks_np(m)`` as
    contiguous float32 (8, m) tensors on ``device``."""
    return tuple(torch.from_numpy(a).to(device) for a in _coef_stacks_np(m))
