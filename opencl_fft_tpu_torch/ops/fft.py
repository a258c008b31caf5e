"""Complex FFT on split (re, im) planes: the hand-written CUDA FFT where the
JAX package runs its Pallas kernel, ``torch.fft`` where it leaves the work
to XLA, and Bluestein's chirp-z for sizes that are not powers of two.

The conventions are the reference's: ``sign=-1`` forward, ``+1`` inverse,
both unnormalized (sum convention), with an optional ``scale`` on the
result (applied in the kernel's last store on the kernel route).

Routing of a power-of-two size (the JAX package's ``_fft_dispatch``):

* ``impl="vmem"``: ``ops/cuda/vmemfft.fft_vmem`` (the kernel on a card,
  its plain twin on the CPU); float64 and sizes outside
  ``vmemfft.supported`` (2^10..2^20) raise ``ValueError``.
* ``impl="auto"``: ``fft_vmem`` for a CUDA float32 tensor whose size is in
  ``vmemfft.supported``; everything else (the CPU, float64, n < 2^10,
  n > 2^20) goes to ``torch.fft``.

The JAX package's other impl names (``mm``, ``stockham``, ``flat``,
``xla``) are TPU plan choices and raise ``ValueError`` here.

Precision. The JAX package's ``set_fast_math`` / ``exact_precision`` pick
the matmul precision of its DFT leaves (bf16x3 or pure bf16 on the TPU's
matrix unit for large leaves, full f32 otherwise). The port keeps both
names and their semantics as a policy (``_fast_mode``), but no transform of
the port runs on a matrix product: the CUDA FFT and ``torch.fft`` are true
float32 in every mode, "turbo" included. The port's float32 products (the
forward partition's table product, the direct FIR's dot products, the
plain twins' DFT and table products) go through
``utils.numerics.exact_matmul``, which gives full-f32 results whatever
torch's process-wide matmul settings are (``set_float32_matmul_precision``,
``allow_tf32``, ``fp32_precision``): the port's counterpart of the JAX
package's ``Precision.HIGHEST``.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..utils.numerics import is_pow2
from .cplx import Cplx, from_complex, to_complex
from .cuda import vmemfft

_IMPLS = ("auto", "vmem")

_FAST_MODE = "auto"            # process-wide policy (set_fast_math)
_FAST_TLS = threading.local()  # per-thread override (exact_precision): the
#                                real-time pipeline runs the engine on a
#                                worker thread beside the caller's thread
_FAST_MODES = ("turbo", "on", "off", "auto")


def _fast_mode() -> str:
    return getattr(_FAST_TLS, "mode", None) or _FAST_MODE


def set_fast_math(enabled: Union[Optional[bool], str]) -> None:
    """The JAX package's leaf-precision policy: True ("on"), False ("off"),
    None ("auto") or "turbo"; strings are case-insensitive and any other
    string raises ValueError.

    On the TPU the modes trade accuracy for the matrix unit's rate. The
    port's transforms use no matrix product (the CUDA FFT and ``torch.fft``
    compute in float32 FMA), so every mode gives the same true-f32 result
    here; the mode is kept so that code written for the JAX package runs
    unchanged, and ``_fast_mode()`` reports it."""
    global _FAST_MODE
    if isinstance(enabled, str):
        mode = enabled.lower()
        if mode not in _FAST_MODES:
            raise ValueError(
                f"set_fast_math: unknown mode {enabled!r} "
                f"(expected True/False/None or one of {sorted(_FAST_MODES)})")
        _FAST_MODE = mode
        return
    _FAST_MODE = "auto" if enabled is None else ("on" if enabled else "off")


@contextlib.contextmanager
def exact_precision():
    """Force the "off" (full f32) policy inside the context; thread-local,
    so a concurrent thread keeps its own policy (JAX ``ops/fft.py``). The
    port's results are full f32 in every mode (``set_fast_math``)."""
    old = getattr(_FAST_TLS, "mode", None)
    _FAST_TLS.mode = "off"
    try:
        yield
    finally:
        _FAST_TLS.mode = old


@functools.lru_cache(maxsize=None)
def _bluestein_tables_np(n: int, sign: int, npdt=np.float32
                         ) -> Tuple[np.ndarray, ...]:
    """Chirp tables for an n-point DFT via an m-point circular convolution
    (a copy of the JAX package's builder, ``ops/fft.py``).

    With w = exp(sign*2i*pi/n): X[k] = c[k] * sum_n (x[n] c[n]) * conj_c[k-n]
    where c[j] = w^{j^2/2}. Phases use j^2 mod 2n in f64 to avoid large-angle
    trig error. Returns (chirp, B_spectrum) with m = np2(2n - 1).
    """
    m = 2
    while m < 2 * n - 1:
        m <<= 1
    j = np.arange(n, dtype=np.int64)
    phase = (j * j) % (2 * n)
    c = np.exp(sign * 1j * np.pi * phase.astype(np.float64) / n)
    b = np.zeros(m, np.complex128)
    b[:n] = np.conj(c)
    b[m - n + 1:] = np.conj(c[1:][::-1])          # b[-j] = conj(c[j])
    B = np.fft.fft(b)                             # host precompute, f64
    cdt = np.complex128 if np.dtype(npdt) == np.float64 else np.complex64
    return (c.astype(cdt), B.astype(cdt), m)


@functools.lru_cache(maxsize=None)
def _bluestein_dev(n: int, sign: int, dtype: torch.dtype, device: torch.device):
    npdt = np.float64 if dtype == torch.float64 else np.float32
    c, B, m = _bluestein_tables_np(n, sign, npdt)
    planes = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
              for a in (c.real, c.imag, B.real, B.imag)]
    return planes, m


def _fft_bluestein(x: Cplx, sign: int, impl: str) -> Cplx:
    re, im = x
    n = re.shape[-1]
    (cr, ci, Br, Bi), m = _bluestein_dev(n, sign, re.dtype, re.device)
    ar = re * cr - im * ci
    ai = re * ci + im * cr
    pad = (0, m - n)
    Ar, Ai = _fft_dispatch((torch.nn.functional.pad(ar, pad),
                            torch.nn.functional.pad(ai, pad)), -1, impl)
    Yr = Ar * Br - Ai * Bi
    Yi = Ar * Bi + Ai * Br
    yr, yi = _fft_dispatch((Yr, Yi), +1, impl)
    yr, yi = yr[..., :n] / m, yi[..., :n] / m
    return yr * cr - yi * ci, yr * ci + yi * cr


def _fft_torch(x: Cplx, sign: int, scale: float) -> Cplx:
    z = torch.complex(*x)
    z = (torch.fft.fft(z) if sign == -1
         else torch.fft.ifft(z, norm="forward"))
    if scale != 1.0:
        z = z * scale
    return z.real.contiguous(), z.imag.contiguous()


def uses_vmem(n: int, dtype: torch.dtype, device: torch.device, impl: str) -> bool:
    """Whether a power-of-two transform of n points goes to
    ``vmemfft.fft_vmem`` (else ``torch.fft``)."""
    return impl == "vmem" or (device.type == "cuda" and dtype == torch.float32
                              and vmemfft.supported(n))


def _fft_dispatch(x: Cplx, sign: int, impl: str, scale: float = 1.0) -> Cplx:
    """Power-of-two dispatch (impl already validated); returns scale *
    DFT(x)."""
    re = x[0]
    if impl == "vmem" and re.dtype != torch.float32:
        raise ValueError("impl='vmem' is float32-only (the CUDA FFT kernel)")
    if uses_vmem(re.shape[-1], re.dtype, re.device, impl):
        return vmemfft.fft_vmem(x, sign, scale)
    return _fft_torch(x, sign, scale)


def fft_split(x: Cplx, sign: int, impl: str = "auto",
              scale: float = 1.0) -> Cplx:
    """Unnormalized DFT over the last axis of a split (re, im) pair;
    returns ``scale * DFT(x)``.

    float64 planes stay float64; everything else is computed in float32.
    Sizes that are not powers of two go through Bluestein (its
    power-of-two core through the same routing).
    """
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r}, expected one of {_IMPLS}")
    if sign not in (-1, 1):
        raise ValueError("sign must be -1 (forward) or +1 (inverse)")
    re, im = x
    dt = torch.float64 if torch.float64 in (re.dtype, im.dtype) else torch.float32
    re, im = re.to(dt), im.to(dt)
    if re.shape != im.shape:
        raise ValueError(f"re/im shapes differ: {tuple(re.shape)} vs {tuple(im.shape)}")
    n = re.shape[-1]
    if n < 1:
        raise ValueError("empty transform")
    if n == 1:
        return (re, im) if scale == 1.0 else (re * scale, im * scale)
    if not is_pow2(n):
        if impl == "vmem":
            # fail here with the user's n, not the padded internal size
            raise ValueError(
                f"impl='vmem' needs a power-of-two size in the kernel's "
                f"domain, got {n}; use impl='auto'")
        out = _fft_bluestein((re, im), sign, impl)
        if scale != 1.0:
            out = (out[0] * scale, out[1] * scale)
        return out
    return _fft_dispatch((re, im), sign, impl, scale)


def fft_unnormalized(x: torch.Tensor, sign: int, impl: str = "auto") -> torch.Tensor:
    """Complex-tensor convenience wrapper around fft_split."""
    return to_complex(fft_split(from_complex(x), sign, impl))


def cfft_split(x: Cplx, forward: bool = True, impl: str = "auto") -> Cplx:
    """Reference-convention FFT on split data (Clcfft::transform parity).

    forward=True  -> DFT(x) / N
    forward=False -> unnormalized inverse DFT (sum convention)
    """
    n = x[0].shape[-1]
    return fft_split(x, -1 if forward else +1, impl,
                     scale=1.0 / n if forward else 1.0)


def cfft(x: torch.Tensor, forward: bool = True, impl: str = "auto") -> torch.Tensor:
    """Complex-tensor wrapper for cfft_split."""
    return to_complex(cfft_split(from_complex(x), forward, impl))


def fft(x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Standard-convention forward DFT (no scaling)."""
    return fft_unnormalized(x, -1, impl)


def ifft(x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Standard-convention inverse DFT (scaled by 1/N)."""
    return fft_unnormalized(x, +1, impl) / x.shape[-1]
