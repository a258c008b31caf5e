"""Batched complex FFT of float32 split planes: the CUDA kernels of
``csrc/fft.cu`` and their plain PyTorch twins.

Counterparts of ``opencl_fft_tpu/ops/pallas/vmemfft.py`` ``supported``,
``fft_vmem`` and ``fft_vmem_front2``, with the same results: scale *
DFT_sign(x) over the last axis of (..., n) split planes, sign = -1 forward,
+1 the unnormalized inverse, n a power of two in [2^10, 2^20].

``fft_vmem`` transforms a row in one pass (``fft_rows_f32``: radix-16
Stockham passes in registers and shared memory) up to
``SINGLE_PASS_MAX``; above it, it takes ``fft_vmem_front2``'s two-pass
route at the split ``default_split``.
``fft_vmem_front2`` is the four-step in two passes for n = n1 * n2: the
n1-point transforms down the columns of the (n1, n2) matrix times the
twiddles W_n^(k1 j2) (``fft_front_f32``), then the n2-point leaf
transforms of the rows, stored transposed to out[k1 + n1 k2]
(``fft_rows_f32``). By default n2 = 256 and n in [2^18, 2^20], the JAX
plan's last factor f3 and domain (``_PLANS_F2``); ``split`` takes the place
of JAX's ``plan_override``.

Each wrapper runs its CUDA kernels for CUDA tensors and its twin for CPU
tensors; anything else raises. ``LAUNCHES`` counts the single-pass
launches of ``fft_vmem``, ``FRONT2_LAUNCHES`` the launches of the
two-pass route (by ``fft_vmem_front2``, or by ``fft_vmem`` above
``SINGLE_PASS_MAX``).

The twins follow the kernels' factorization: the same n1 x n2 split and
the same float32 twiddle tables, with every shorter transform done as
products with float64-built DFT matrices of at most ``LEAF_MAX`` points
(true float32 products; TF32 must be off on a card).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ...utils.numerics import is_pow2
from ..cplx import Cplx
from . import _build

LAUNCHES = 0
FRONT2_LAUNCHES = 0

MIN_N = 1 << 10
MAX_N = 1 << 20
SINGLE_PASS_MAX = 1 << 13     # one CTA holds 8192 complex values (64 KB)
FRONT2_SIZES = (1 << 18, 1 << 19, 1 << 20)
FRONT2_N2 = 256
LEAF_MAX = 64                 # the twins' largest DFT matrix

Split = Tuple[int, int]


def supported(n: int) -> bool:
    """n is a power of two in [2^10, 2^20]: the JAX kernel's domain."""
    return is_pow2(n) and MIN_N <= n <= MAX_N


def default_split(n: int) -> Split:
    """``fft_vmem``'s two-pass split above ``SINGLE_PASS_MAX``: n1 =
    2^floor(log2(n)/2) front points, n2 = n / n1 leaf points."""
    n1 = 1 << ((n.bit_length() - 1) // 2)
    return n1, n // n1


def front2_split(n: int, split: Optional[Split] = None) -> Split:
    """The (n1, n2) that ``fft_vmem_front2`` uses for size n: (n / 256,
    256) for n in 2^18..2^20, or ``split`` for any supported n when both
    factors are powers of two in [2, 8192] with n1 * n2 = n."""
    if split is None:
        if n not in FRONT2_SIZES:
            raise ValueError(f"fft_vmem_front2: no default split for size {n} "
                             f"(defaults exist for {FRONT2_SIZES}); pass split=(n1, n2)")
        return n // FRONT2_N2, FRONT2_N2
    n1, n2 = (int(f) for f in split)
    if not supported(n) or n1 * n2 != n or not (is_pow2(n1) and is_pow2(n2)) \
            or not (2 <= n1 <= SINGLE_PASS_MAX and 2 <= n2 <= SINGLE_PASS_MAX):
        raise ValueError(f"fft_vmem_front2: split {split} does not factor size {n} "
                         f"into powers of two in [2, {SINGLE_PASS_MAX}]")
    return n1, n2


# ---------------------------------------------------------------------------
# Host tables, float64 trig rounded once to float32
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def stage_twiddle_np(n: int, sign: int) -> Tuple[np.ndarray, np.ndarray]:
    """W_n^k = exp(sign 2 pi i k / n) for k < n, split float32: the
    kernels' Stockham-pass table (angle index reduced mod n in integers)."""
    ph = (np.arange(n, dtype=np.int64) % n).astype(np.float64)
    w = np.exp(sign * 2j * np.pi * ph / n)
    return w.real.astype(np.float32), w.imag.astype(np.float32)


@functools.lru_cache(maxsize=None)
def four_step_twiddle_np(n1: int, n2: int, sign: int) -> Tuple[np.ndarray, np.ndarray]:
    """(n1, n2) table W_n^(k1 j2), n = n1 n2, split float32: the front
    pass's twiddles (k1 j2 reduced mod n in integers; the JAX package's
    ``vmemfft._twiddle_np(n1, n2, sign)``)."""
    ph = (np.outer(np.arange(n1, dtype=np.int64), np.arange(n2, dtype=np.int64))
          % (n1 * n2)).astype(np.float64)
    w = np.exp(sign * 2j * np.pi * ph / (n1 * n2))
    return w.real.astype(np.float32), w.imag.astype(np.float32)


@functools.lru_cache(maxsize=None)
def dft_matrix_np(n: int, sign: int) -> Tuple[np.ndarray, np.ndarray]:
    """(n, n) DFT matrix W[j, k] = exp(sign 2 pi i jk / n), split float32
    (jk reduced mod n in integers): the twins' short transforms."""
    jk = (np.outer(np.arange(n, dtype=np.int64), np.arange(n, dtype=np.int64))
          % n).astype(np.float64)
    w = np.exp(sign * 2j * np.pi * jk / n)
    return w.real.astype(np.float32), w.imag.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _table(kind: str, args: tuple, device: torch.device) -> Cplx:
    builder = {"stage": stage_twiddle_np, "four": four_step_twiddle_np,
               "dft": dft_matrix_np}[kind]
    wr, wi = builder(*args)
    return torch.from_numpy(wr).to(device), torch.from_numpy(wi).to(device)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _rows_kernel():
    fn = _build.load("fft").fft_rows_f32
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 6 + [ctypes.c_longlong, i, i, i, ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _front_kernel():
    fn = _build.load("fft").fft_front_f32
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 8 + [ctypes.c_longlong, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _log2(n: int) -> int:
    return n.bit_length() - 1


def _check(name: str, x: Cplx, sign: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The planes, checked to be (..., n) of one shape; and n."""
    if sign not in (-1, 1):
        raise ValueError(f"{name}: sign must be -1 (forward) or +1 (inverse)")
    re, im = x
    if re.shape != im.shape or re.dim() < 1:
        raise ValueError(f"{name}: re/im must be (..., n) of one shape, got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    return re, im, re.shape[-1]


def _rows_2d(name: str, x: Cplx, sign: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The planes as contiguous (rows, n), checked; and n."""
    re, im, n = _check(name, x, sign)
    return re.reshape(-1, n).contiguous(), im.reshape(-1, n).contiguous(), n


def route(n: int) -> str:
    """The CUDA kernels ``fft_vmem`` runs for size n, for logs."""
    if n <= SINGLE_PASS_MAX:
        return f"fft_rows_kernel of csrc/fft.cu (one pass of {n} points)"
    n1, n2 = default_split(n)
    return f"fft_front_kernel + fft_rows_kernel of csrc/fft.cu (two passes, {n} = {n1} x {n2})"


def _check_rows(name, re, im):
    if re.shape[0] < 1:
        raise ValueError(f"{name}: no rows to transform")
    return _build.launch_device(name, (re, im))


def _planes_like(re: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two float32 planes of re's shape and device, from one allocation."""
    return torch.empty((2,) + tuple(re.shape), dtype=torch.float32, device=re.device).unbind(0)


def _launch_rows(xr, xi, yr, yi, log_l, log_n1, sign, scale, dev, stream):
    twr, twi = _table("stage", (1 << log_l, sign), dev)
    rows = xr.numel() >> log_l
    err = _rows_kernel()(xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                         twr.data_ptr(), twi.data_ptr(), rows, log_l, log_n1, sign,
                         float(scale), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"fft_rows_f32: CUDA error {err} at launch")


def _two_pass(re, im, shape, n1, n2, sign, scale, dev) -> Cplx:
    """The front pass and the leaf pass on contiguous (rows, n1 n2) CUDA
    planes; counts one ``FRONT2_LAUNCHES``."""
    global FRONT2_LAUNCHES
    twr, twi = _table("stage", (n1, sign), dev)
    t4r, t4i = _table("four", (n1, n2, sign), dev)
    sr, si = _planes_like(re)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _front_kernel()(re.data_ptr(), im.data_ptr(), sr.data_ptr(), si.data_ptr(),
                          twr.data_ptr(), twi.data_ptr(), t4r.data_ptr(), t4i.data_ptr(),
                          re.shape[0], _log2(n1), _log2(n2), sign, dev.index, stream)
    if err != 0:
        raise RuntimeError(f"fft_front_f32: CUDA error {err} at launch")
    yr, yi = _planes_like(re)
    _launch_rows(sr, si, yr, yi, _log2(n2), _log2(n1), sign, scale, dev, stream)
    FRONT2_LAUNCHES += 1
    return yr.reshape(shape), yi.reshape(shape)


def fft_vmem(x: Cplx, sign: int, scale: float = 1.0) -> Cplx:
    """scale * DFT_sign over the last axis of split float32 planes (..., n),
    n in ``supported``. Single pass up to ``SINGLE_PASS_MAX``, else the
    two-pass route of ``fft_vmem_front2`` at ``default_split(n)``."""
    global LAUNCHES
    re, im, n = _rows_2d("fft_vmem", x, sign)
    if not supported(n):
        raise ValueError(f"vmem fft: unsupported size {n}")
    dev = _check_rows("fft_vmem", re, im)
    if dev.type == "cpu":
        return fft_vmem_plain(x, sign, scale)
    if n > SINGLE_PASS_MAX:
        return _two_pass(re, im, x[0].shape, *default_split(n), sign, scale, dev)
    yr, yi = _planes_like(re)
    _launch_rows(re, im, yr, yi, _log2(n), 0, sign, scale, dev,
                 torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES += 1
    return yr.reshape(x[0].shape), yi.reshape(x[0].shape)


def fft_vmem_front2(x: Cplx, sign: int, scale: float = 1.0,
                    split: Optional[Split] = None) -> Cplx:
    """scale * DFT_sign over the last axis of split float32 planes (..., n)
    as the two-pass four-step at ``front2_split(n, split)``."""
    re, im, n = _rows_2d("fft_vmem_front2", x, sign)
    n1, n2 = front2_split(n, split)
    dev = _check_rows("fft_vmem_front2", re, im)
    if dev.type == "cpu":
        return fft_vmem_front2_plain(x, sign, scale, (n1, n2))
    return _two_pass(re, im, x[0].shape, n1, n2, sign, scale, dev)


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------


def _dft_plain(re: torch.Tensor, im: torch.Tensor, sign: int) -> Cplx:
    """Unnormalized DFT over the last axis (a power of two): one product
    with the DFT matrix up to ``LEAF_MAX`` points, else the four-step with
    a ``LEAF_MAX``-point front: out[k1 + l1 k2] = DFT_l2(W_L^(k1 j2) *
    DFT_l1 over the columns)."""
    n = re.shape[-1]
    if n <= LEAF_MAX:
        wr, wi = _table("dft", (n, sign), re.device)
        return re @ wr - im @ wi, re @ wi + im @ wr
    l1 = LEAF_MAX
    return _four_step_plain(re, im, sign, l1, n // l1)


def _four_step_plain(re, im, sign, n1, n2) -> Cplx:
    lead = re.shape[:-1]
    n = n1 * n2
    # columns j2 of the (n1, n2) matrix as rows, transformed over j1
    ar, ai = _dft_plain(re.reshape(lead + (n1, n2)).transpose(-1, -2),
                        im.reshape(lead + (n1, n2)).transpose(-1, -2), sign)
    ar, ai = ar.transpose(-1, -2), ai.transpose(-1, -2)        # (..., k1, j2)
    tr, ti = _table("four", (n1, n2, sign), re.device)
    br, bi = ar * tr - ai * ti, ar * ti + ai * tr
    zr, zi = _dft_plain(br, bi, sign)                          # (..., k1, k2)
    return (zr.transpose(-1, -2).reshape(lead + (n,)),
            zi.transpose(-1, -2).reshape(lead + (n,)))


def fft_vmem_plain(x: Cplx, sign: int, scale: float = 1.0) -> Cplx:
    """Plain PyTorch twin of ``fft_vmem``: the single-pass transform up to
    ``SINGLE_PASS_MAX``, else ``fft_vmem_front2_plain`` at
    ``default_split(n)``; scale applied once, last."""
    re, im, n = _check("fft_vmem", x, sign)
    re, im = re.to(torch.float32), im.to(torch.float32)
    if not supported(n):
        raise ValueError(f"vmem fft: unsupported size {n}")
    if n > SINGLE_PASS_MAX:
        return fft_vmem_front2_plain(x, sign, scale, default_split(n))
    yr, yi = _dft_plain(re, im, sign)
    return yr * scale, yi * scale


def fft_vmem_front2_plain(x: Cplx, sign: int, scale: float = 1.0,
                          split: Optional[Split] = None) -> Cplx:
    """Plain PyTorch twin of ``fft_vmem_front2``: the four-step at the same
    (n1, n2) split with the same tables; scale applied once, last."""
    re, im, n = _check("fft_vmem_front2", x, sign)
    re, im = re.to(torch.float32), im.to(torch.float32)
    n1, n2 = front2_split(n, split)
    yr, yi = _four_step_plain(re, im, sign, n1, n2)
    return yr * scale, yi * scale
