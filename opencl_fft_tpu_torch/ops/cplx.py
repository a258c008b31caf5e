"""Split-complex helpers: a complex tensor is a pair (re, im) of real tensors.

The public boundary keeps the JAX package's split layout so that spectra
and streaming state compare, and cross, plane for plane.
"""

from __future__ import annotations

from typing import Tuple

import torch

Cplx = Tuple[torch.Tensor, torch.Tensor]


def cmul(a: Cplx, b: Cplx) -> Cplx:
    """(a.re + i a.im)(b.re + i b.im) — the `prod` helper, cl_fft.cpp:20-22."""
    ar, ai = a
    br, bi = b
    return ar * br - ai * bi, ar * bi + ai * br


def conj(a: Cplx) -> Cplx:
    ar, ai = a
    return ar, -ai


def rot(a: Cplx) -> Cplx:
    """Multiply by i — the `rot` helper, cl_fft.cpp:173-176."""
    ar, ai = a
    return -ai, ar


def cadd(a: Cplx, b: Cplx) -> Cplx:
    return a[0] + b[0], a[1] + b[1]


def csub(a: Cplx, b: Cplx) -> Cplx:
    return a[0] - b[0], a[1] - b[1]


def cscale(a: Cplx, s) -> Cplx:
    return a[0] * s, a[1] * s


def from_complex(x: torch.Tensor) -> Cplx:
    """Complex (or real) tensor -> split pair. complex128/float64 keep f64
    planes, everything else becomes f32."""
    if x.is_complex():
        dt = torch.float64 if x.dtype == torch.complex128 else torch.float32
        return x.real.to(dt), x.imag.to(dt)
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    x = x.to(dt)
    return x, torch.zeros_like(x)


def to_complex(a: Cplx) -> torch.Tensor:
    """Split pair -> complex tensor. f64 planes give complex128, anything
    else complex64."""
    re, im = a
    dt = torch.float64 if torch.float64 in (re.dtype, im.dtype) else torch.float32
    return torch.complex(re.to(dt), im.to(dt))
