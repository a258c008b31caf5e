"""Real <-> complex FFT with the reference's packed-spectrum convention.

Capability parity with ``Clrfft`` (``cl_fft.h:74-111``): an N-point real
transform computed as an N/2-point complex FFT plus a pack/unpack pass.

Packed-spectrum convention (M = N/2 complex bins):
  * bin 0 holds (DC/2, Nyquist/2) as (re, im) — ``cl_fft.cpp:181``;
  * bins 1..M-1 hold the usual non-negative-frequency spectrum, EXCEPT
  * bin M/2, which the reference kernels never touch, leaving the raw
    half-size-FFT value (the conjugate of the true bin). Forward and
    inverse both skip the conjugation, so roundtrips and spectral products
    stay exact.

Complex data is carried split as (re, im) planes; every function is
batched over leading axes. ``rfft``/``irfft`` are the complex-tensor
wrappers, and ``packed_to_standard``/``standard_to_packed`` convert to and
from numpy's (M+1)-bin rfft layout.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .cplx import Cplx, from_complex, to_complex
from .fft import fft_split


@functools.lru_cache(maxsize=None)
def _half_twiddle_np(m: int, sign: int, npdt=np.float32
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """w2[i] = exp(sign * i*pi * idx / m), split — cl_fft.cpp:233-238 recipe."""
    i = np.arange(m, dtype=np.float64)
    w = np.exp(sign * 1j * np.pi * i / m)
    return w.real.astype(npdt), w.imag.astype(npdt)


@functools.lru_cache(maxsize=None)
def _twiddle_dev(m: int, sign: int, dtype: torch.dtype,
                 device: torch.device) -> Cplx:
    npdt = np.float64 if dtype == torch.float64 else np.float32
    wr, wi = _half_twiddle_np(m, sign, npdt)
    return torch.from_numpy(wr).to(device), torch.from_numpy(wi).to(device)


def _twiddle(m: int, sign: int, like: torch.Tensor) -> Cplx:
    return _twiddle_dev(m, sign, like.dtype, like.device)


def _flip(a: torch.Tensor) -> torch.Tensor:
    """a[(M - i) % M] over the last axis."""
    m = a.shape[-1]
    idx = (-torch.arange(m, device=a.device)) % m
    return a[..., idx]


def pack_forward(c: Cplx) -> Cplx:
    """Forward pack: half-size FFT output -> packed real spectrum (the
    ``conv`` kernel, cl_fft.cpp:178-191, evaluated at every index at once;
    bins 0 and M/2 are then restored)."""
    re, im = c
    m = re.shape[-1]
    wr, wi = _twiddle(m, -1, re)
    fr, fi = _flip(re), _flip(im)
    er = 0.5 * (re + fr)
    ei = 0.5 * (im - fi)
    outr_ = 0.5 * (fi + im)            # o = 0.5 * rot(cjs - c)
    outi_ = 0.5 * (fr - re)
    outr = er + (wr * outr_ - wi * outi_)
    outi = ei + (wr * outi_ + wi * outr_)
    outr[..., 0] = (re[..., 0] + im[..., 0]) * 0.5
    outi[..., 0] = (re[..., 0] - im[..., 0]) * 0.5
    if m >= 2:
        outr[..., m // 2] = re[..., m // 2]        # untouched bin
        outi[..., m // 2] = im[..., m // 2]
    return outr, outi


def unpack_inverse(c: Cplx) -> Cplx:
    """Inverse unpack: packed real spectrum -> half-size FFT input (the
    ``iconv`` kernel, cl_fft.cpp:192-205); bin 0 has NO 0.5 factor here."""
    re, im = c
    m = re.shape[-1]
    wr, wi = _twiddle(m, +1, re)
    fr, fi = _flip(re), _flip(im)
    er = 0.5 * (re + fr)
    ei = 0.5 * (im - fi)
    outr_ = -0.5 * (im + fi)           # o = 0.5 * rot(c - cjs)
    outi_ = 0.5 * (re - fr)
    outr = er + (wr * outr_ - wi * outi_)
    outi = ei + (wr * outi_ + wi * outr_)
    outr[..., 0] = re[..., 0] + im[..., 0]
    outi[..., 0] = re[..., 0] - im[..., 0]
    if m >= 2:
        outr[..., m // 2] = re[..., m // 2]
        outi[..., m // 2] = im[..., m // 2]
    return outr, outi


def deinterleave(r: torch.Tensor) -> Cplx:
    """(..., N) reals -> split pair z[n] = r[2n] + i*r[2n+1] (the 'reinterpret
    real buffer as complex' step, cl_fft.cpp:270). f64 keeps f64 planes."""
    dt = torch.float64 if r.dtype == torch.float64 else torch.float32
    r = r.to(dt).reshape(r.shape[:-1] + (r.shape[-1] // 2, 2))
    return r[..., 0], r[..., 1]


def interleave(z: Cplx) -> torch.Tensor:
    """Inverse of deinterleave: split pair -> (..., 2M) reals."""
    re, im = z
    return torch.stack([re, im], dim=-1).reshape(re.shape[:-1] + (2 * re.shape[-1],))


def rfft_split(r: torch.Tensor, impl: str = "auto",
               unnormalized: bool = False) -> Cplx:
    """Forward real FFT, packed convention (Clrfft forward parity).

    r: (..., N) -> split (..., N/2) packed spectrum. Scales by 1/(N/2) like
    the reference's forward object unless ``unnormalized``.
    """
    n = r.shape[-1]
    if n < 4 or n % 4:
        # the packed convention needs an even complex bin count: bin M/2 is
        # the self-conjugate bin the kernels leave untouched
        raise ValueError(
            f"real FFT size must be a multiple of 4 (even complex bin "
            f"count) and >= 4, got {n}")
    cr, ci = fft_split(deinterleave(r), -1, impl,
                       scale=1.0 if unnormalized else 2.0 / n)
    return pack_forward((cr, ci))


def irfft_split(c: Cplx, impl: str = "auto", scale: float = 1.0) -> torch.Tensor:
    """Inverse real FFT, packed convention (Clrfft inverse parity).

    c: split (..., M) packed spectrum -> (..., 2M) time data, unnormalized
    (irfft(rfft(x)) == x when rfft used the default 1/M scaling).
    """
    return interleave(fft_split(unpack_inverse(c), +1, impl, scale=scale))


def rfft(r: torch.Tensor, impl: str = "auto", unnormalized: bool = False) -> torch.Tensor:
    """Complex-tensor wrapper for rfft_split: (..., N) reals -> (..., N/2)
    packed complex spectrum."""
    return to_complex(rfft_split(r, impl, unnormalized))


def irfft(c: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Complex-tensor wrapper for irfft_split: (..., M) packed complex
    spectrum -> (..., 2M) reals."""
    return irfft_split(from_complex(c), impl)


# ---------------------------------------------------------------------------
# Interop with the standard (numpy) rfft layout
# ---------------------------------------------------------------------------

def packed_to_standard(c: torch.Tensor) -> torch.Tensor:
    """Packed (M bins) -> standard rfft layout (M+1 bins, numpy convention).

    Inverts the reference packing: bin0 (re,im) = (DC/2, Nyq/2); bin M/2 is
    stored conjugated (the skipped conjugation described in the module doc).
    """
    m = c.shape[-1]
    full = torch.cat([c, torch.zeros(c.shape[:-1] + (1,), dtype=c.dtype,
                                     device=c.device)], dim=-1)
    full[..., 0] = 2.0 * c[..., 0].real
    full[..., m] = 2.0 * c[..., 0].imag
    full[..., m // 2] = torch.conj(c[..., m // 2])
    return full


def standard_to_packed(s: torch.Tensor) -> torch.Tensor:
    """Standard rfft layout (M+1 bins) -> reference packed layout (M bins)."""
    m = s.shape[-1] - 1
    packed = s[..., :m].clone()
    packed[..., 0] = torch.complex(0.5 * s[..., 0].real, 0.5 * s[..., m].real)
    packed[..., m // 2] = torch.conj(s[..., m // 2])
    return packed
