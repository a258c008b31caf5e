"""Power-of-two complex FFT on split (re, im) planes, on ``torch.fft``.

The JAX package carries its own matmul / Stockham / on-chip transform
plans because its backend had no fast complex FFT; here the transform is
``torch.fft`` (cuFFT on a card, pocketfft on the CPU). The conventions are
the reference's: ``sign=-1`` forward, ``+1`` inverse, both unnormalized
(sum convention), with an optional ``scale`` on the result.
"""

from __future__ import annotations

import torch

from ..utils.numerics import is_pow2
from .cplx import Cplx

_IMPLS = ("auto",)


def fft_split(x: Cplx, sign: int, impl: str = "auto",
              scale: float = 1.0) -> Cplx:
    """Unnormalized DFT over the last axis of a split (re, im) pair;
    returns ``scale * DFT(x)``.

    float64 planes stay float64; everything else is computed in float32.
    Sizes that are not powers of two (the JAX package's Bluestein route)
    are not ported yet: ROADMAP queue 1 item 7.
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
        raise NotImplementedError(
            f"FFT size {n} is not a power of two; Bluestein sizes are not "
            f"ported yet (ROADMAP queue 1 item 7)")
    z = torch.complex(re, im)
    z = (torch.fft.fft(z) if sign == -1
         else torch.fft.ifft(z, norm="forward"))
    if scale != 1.0:
        z = z * scale
    return z.real.contiguous(), z.imag.contiguous()


def cfft_split(x: Cplx, forward: bool = True, impl: str = "auto") -> Cplx:
    """Reference-convention FFT on split data (Clcfft::transform parity).

    forward=True  -> DFT(x) / N
    forward=False -> unnormalized inverse DFT (sum convention)
    """
    n = x[0].shape[-1]
    return fft_split(x, -1 if forward else +1, impl,
                     scale=1.0 / n if forward else 1.0)
