"""Batched complex FFT of float32 split planes: the CUDA kernels of
``csrc/fft.cu`` and their plain PyTorch twins.

Counterparts of ``opencl_fft_tpu/ops/pallas/vmemfft.py`` ``supported``,
``fft_vmem`` and ``fft_vmem_front2``, with the same results: scale *
DFT_sign(x) over the last axis of (..., n) split planes, sign = -1 forward,
+1 the unnormalized inverse, n a power of two in [2^10, 2^20].

``route(n, split)`` picks the kernels by size, for both wrappers:

- ``rows``, n <= ``SINGLE_PASS_MAX``: one pass over device memory
  (``fft_rows_pipe_f32``: radix-16 Stockham passes in registers and shared
  memory; persistent CTAs walk tiles of whole rows, and a bulk
  asynchronous copy refills a CTA's tile while its last pass runs and the
  SM's other CTAs compute);
- ``two_pass`` above it: the four-step in two passes over device memory at
  n = n1 x n2, ``two_pass_split(n)`` or an explicit ``split=(n1, n2)``, n1
  and n2 at most ``LEAF_PASS_MAX``: the n1-point transforms down the
  columns of the (n1, n2) matrix (``fft_front_f32``), then the n2-point
  leaf transforms of the rows, each value multiplied by the twiddle
  W_n^(k1 j2) as it is loaded, stored transposed to out[k1 + n1 k2]
  (``fft_rows_f32``).

``fft_vmem_front2`` takes ``split`` in the place of JAX's ``plan_override``;
without one it runs the JAX plan's domain, n in 2^18..2^20
(``FRONT2_SIZES``), by the same route as ``fft_vmem``.

Each wrapper runs its CUDA kernels for CUDA tensors and its twin for CPU
tensors; anything else raises. ``LAUNCHES`` counts the single-pass
launches of ``fft_vmem``, ``FRONT2_LAUNCHES`` the launches of the
two-pass route (one front and one leaf pass), by
``fft_vmem_front2`` or by ``fft_vmem`` above ``SINGLE_PASS_MAX``.

The twins follow the kernels' factorization: the same n1 x n2 split and
float32 twiddles rounded once from float64 (the kernels form W_n^(k1 j2)
as the product of three such table entries), with every shorter transform
done as products with float64-built DFT matrices of at most ``LEAF_MAX``
points (true float32 products; TF32 must be off on a card).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...utils.numerics import exact_matmul, is_pow2
from ..cplx import Cplx
from . import _build

LAUNCHES = 0
FRONT2_LAUNCHES = 0

MIN_N = 1 << 10
MAX_N = 1 << 20
SINGLE_PASS_MAX = 1 << 14     # the single pass: one CTA holds a row of 2^14 values
LEAF_PASS_MAX = 1 << 13       # a two-pass factor: a leaf CTA holds 2^13 values
FRONT2_SIZES = (1 << 18, 1 << 19, 1 << 20)
LEAF_MAX = 64                 # the twins' largest DFT matrix

Split = Tuple[int, int]


class Route(NamedTuple):
    """The CUDA kernels for one size: ``kind`` "rows" (n1 = 1, n2 = n) or
    "two_pass" (n1 front points, n2 leaf points)."""

    kind: str
    n1: int
    n2: int

    def __str__(self) -> str:
        n = self.n1 * self.n2
        if self.kind == "rows":
            return f"fft_rows_pipe_kernel of csrc/fft.cu (one pass of {n} points)"
        return (f"fft_front_kernel + fft_rows_kernel of csrc/fft.cu (two passes, "
                f"{n} = {self.n1} x {self.n2})")


def supported(n: int) -> bool:
    """n is a power of two in [2^10, 2^20]: the JAX kernel's domain."""
    return is_pow2(n) and MIN_N <= n <= MAX_N


def two_pass_split(n: int) -> Split:
    """The default (n1, n2) of the two passes: n1 = 256 front points up to
    2^18 (32 columns a CTA: 128-byte segments), 1024 above (where 256 would
    leave the leaf 4 rows a CTA: 16-byte stores). Chosen by timing the
    splits of 2^14..2^20 on the H100 (PERF.md). Above 2^23 (the scans'
    transforms, ``ops/cuda/streamstep.py``) n1 grows so that the leaf
    keeps ``LEAF_PASS_MAX`` points."""
    n1 = 256 if n <= 1 << 18 else max(1024, n // LEAF_PASS_MAX)
    return n1, n // n1


def route(n: int, split: Optional[Split] = None) -> Route:
    """The kernels that transform size n (``supported``): with ``split``,
    the two passes at (n1, n2) = split, both powers of two in [2,
    ``LEAF_PASS_MAX``] with n1 * n2 = n; else one pass up to
    ``SINGLE_PASS_MAX`` and two passes at ``two_pass_split(n)`` above."""
    if not supported(n):
        raise ValueError(f"vmem fft: unsupported size {n}")
    if split is not None:
        n1, n2 = (int(f) for f in split)
        if n1 * n2 != n or not (is_pow2(n1) and is_pow2(n2)) \
                or not (2 <= n1 <= LEAF_PASS_MAX and 2 <= n2 <= LEAF_PASS_MAX):
            raise ValueError(f"fft_vmem_front2: split {split} does not factor size {n} "
                             f"into powers of two in [2, {LEAF_PASS_MAX}]")
        return Route("two_pass", n1, n2)
    if n <= SINGLE_PASS_MAX:
        return Route("rows", 1, n)
    return Route("two_pass", *two_pass_split(n))


# ---------------------------------------------------------------------------
# Host tables, float64 trig rounded once to float32
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def stage_twiddle_np(n: int, sign: int) -> Tuple[np.ndarray, np.ndarray]:
    """W_n^k = exp(sign 2 pi i k / n) for k < n, split float32 (angle
    index reduced mod n in integers): the values of the kernels' pass
    tables (``pass_twiddle_np``)."""
    ph = (np.arange(n, dtype=np.int64) % n).astype(np.float64)
    w = np.exp(sign * 2j * np.pi * ph / n)
    return w.real.astype(np.float32), w.imag.astype(np.float32)


@functools.lru_cache(maxsize=None)
def four_step_twiddle_np(n1: int, n2: int, sign: int) -> Tuple[np.ndarray, np.ndarray]:
    """(n1, n2) table W_n^(k1 j2), n = n1 n2, split float32: the twins'
    four-step twiddles (k1 j2 reduced mod n in integers; the JAX package's
    ``vmemfft._twiddle_np(n1, n2, sign)``), which the kernels form from the
    smaller ``four_step_tables_np``."""
    ph = (np.outer(np.arange(n1, dtype=np.int64), np.arange(n2, dtype=np.int64))
          % (n1 * n2)).astype(np.float64)
    w = np.exp(sign * 2j * np.pi * ph / (n1 * n2))
    return w.real.astype(np.float32), w.imag.astype(np.float32)


def pass_twiddle_np(n: int, sign: int) -> np.ndarray:
    """The kernels' Stockham pass table for transforms of length n, float32
    (re, im) interleaved in a last axis of 2: for each pass after the first
    (radix 16 while four or more bits remain, then 2, 4 or 8), at sub-size
    ns and radix R, the block W_n^(r jm n / (ns R)) at (r - 1) ns + jm for
    1 <= r < R, jm < ns; the entries of ``stage_twiddle_np(n, sign)``."""
    wr, wi = stage_twiddle_np(n, sign)
    log_n, ns, idx = n.bit_length() - 1, 1, []
    for p in range((log_n + 3) // 4):
        radix = 1 << min(4, log_n - 4 * p)
        if ns > 1:
            jm = np.arange(ns, dtype=np.int64)
            idx += [jm * (n // (ns * radix)) * r for r in range(1, radix)]
        ns *= radix
    e = np.concatenate(idx) if idx else np.zeros(0, np.int64)
    return np.ascontiguousarray(np.stack([wr[e], wi[e]], axis=-1))


def four_step_log_a(n2: int) -> int:
    """log2 of the row length of the kernels' twiddle table A for a leaf
    of n2 points: half of log2 n2, rounded up."""
    return n2.bit_length() // 2


@functools.lru_cache(maxsize=None)
def four_step_tables_np(n1: int, n2: int, sign: int) -> Tuple[np.ndarray, ...]:
    """The kernels' twiddle tables for the four-step at n = n1 n2, float32
    (re, im) interleaved in a last axis of 2: A[k1, l] = W_n^(k1 l) for l <
    2^a and B[k1, h] = W_n^(k1 h 2^a) for h < n2 / 2^a, a =
    ``four_step_log_a(n2)``, so W_n^(k1 j2) = A[k1, j2 mod 2^a] *
    B[k1, j2 >> a]; and S[k1, r] = W_n^(k1 r n2 / R) for r < 16, R =
    min(16, n2) the leaf's first radix, so that W_n^(k1 (j + r n2 / R)) =
    W_n^(k1 j) * S[k1, r] (exponents reduced mod n in integers, angles in
    float64)."""
    n, a = n1 * n2, four_step_log_a(n2)
    k1 = np.arange(n1, dtype=np.int64)[:, None]

    def table(e):
        w = np.exp(sign * 2j * np.pi * ((e % n).astype(np.float64) / n))
        return np.stack([w.real, w.imag], axis=-1).astype(np.float32)

    return (table(k1 * np.arange(1 << a, dtype=np.int64)[None, :]),
            table(k1 * (np.arange(n2 >> a, dtype=np.int64)[None, :] << a)),
            table(k1 * np.arange(16, dtype=np.int64)[None, :] * (n2 // min(16, n2))))


@functools.lru_cache(maxsize=None)
def dft_matrix_np(n: int, sign: int) -> Tuple[np.ndarray, np.ndarray]:
    """(n, n) DFT matrix W[j, k] = exp(sign 2 pi i jk / n), split float32
    (jk reduced mod n in integers): the twins' short transforms."""
    jk = (np.outer(np.arange(n, dtype=np.int64), np.arange(n, dtype=np.int64))
          % n).astype(np.float64)
    w = np.exp(sign * 2j * np.pi * jk / n)
    return w.real.astype(np.float32), w.imag.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dft_stack(n: int, sign: int, device: torch.device) -> torch.Tensor:
    """[[wr, wi], [-wi, wr]] of ``dft_matrix_np(n, sign)`` in float64 on
    ``device`` (the float32 values widened), so that [re | im] @ it is
    [re wr - im wi | re wi + im wr]: the twins' leaf DFT as one
    ``exact_matmul``."""
    wr, wi = (torch.from_numpy(w).to(device, torch.float64) for w in dft_matrix_np(n, sign))
    return torch.cat([torch.cat([wr, wi], 1), torch.cat([-wi, wr], 1)], 0)


@functools.lru_cache(maxsize=None)
def _four_table(n1: int, n2: int, sign: int, device: torch.device) -> Cplx:
    wr, wi = four_step_twiddle_np(n1, n2, sign)
    return torch.from_numpy(wr).to(device), torch.from_numpy(wi).to(device)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    fn = getattr(_build.load("fft"), name)
    fn.argtypes = {
        "fft_rows_pipe_f32": [_P] * 5 + [_LL, _I, _I, _F, _I, _P],
        "fft_rows_f32": [_P] * 8 + [_I, _LL, _I, _I, _I, _F, _I, _P],
        "fft_front_f32": [_P] * 5 + [_LL, _I, _I, _I, _I, _P],
    }[name]
    fn.restype = ctypes.c_int
    return fn


def _call(name: str, *args) -> None:
    err = _entry(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


class _Plan(NamedTuple):
    tables: tuple     # the device tables (kept alive with the plan)
    pointers: tuple   # their data pointers: pass tables, then A, B and S


@functools.lru_cache(maxsize=None)
def _plan(r: Route, sign: int, device: torch.device) -> _Plan:
    """The device tables of route r: the pass table of each transform
    length, and for two passes the four-step tables A, B and S."""
    def dev(a):
        return torch.from_numpy(a).to(device)

    if r.kind == "rows":
        tables = (dev(pass_twiddle_np(r.n2, sign)),)
    else:
        tables = (dev(pass_twiddle_np(r.n1, sign)), dev(pass_twiddle_np(r.n2, sign)),
                  *map(dev, four_step_tables_np(r.n1, r.n2, sign)))
    return _Plan(tables, tuple(t.data_ptr() for t in tables))


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

    def rows(p):
        return p if p.dim() == 2 and p.is_contiguous() else p.reshape(-1, n).contiguous()

    return rows(re), rows(im), n


def _check_rows(name, re, im):
    if re.shape[0] < 1:
        raise ValueError(f"{name}: no rows to transform")
    return _build.launch_device(name, (re, im))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data is not 16-byte aligned (the bulk
    copies of the single pass need it; a view at an odd offset is not)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(re, im, shape, r: Route, sign, scale, dev) -> Cplx:
    """The route's kernels on contiguous (rows, n) CUDA planes into new
    planes of ``shape`` (the two halves of one allocation); counts one
    ``LAUNCHES`` (rows) or ``FRONT2_LAUNCHES`` (two passes)."""
    global LAUNCHES, FRONT2_LAUNCHES
    stream = torch._C._cuda_getCurrentRawStream(dev.index)   # current_stream(dev), unwrapped
    y = re.new_empty((2, *shape))
    ptrs = _plan(r, sign, dev).pointers
    half = re.numel() * 4
    y_ = (y.data_ptr(), y.data_ptr() + half)
    rows, idx = re.shape[0], dev.index
    if r.kind == "rows":
        re, im = _aligned(re), _aligned(im)
        _call("fft_rows_pipe_f32", re.data_ptr(), im.data_ptr(), *y_, ptrs[0], rows,
              _log2(r.n2), sign, scale, idx, stream)
        LAUNCHES += 1
        return y[0], y[1]
    s = re.new_empty((2, *re.shape))
    s_ = (s.data_ptr(), s.data_ptr() + half)
    _call("fft_front_f32", re.data_ptr(), im.data_ptr(), *s_, ptrs[0], rows, _log2(r.n1),
          _log2(r.n2), sign, idx, stream)
    _call("fft_rows_f32", *s_, *y_, *ptrs[1:], four_step_log_a(r.n2), rows * r.n1, _log2(r.n2),
          _log2(r.n1), sign, scale, idx, stream)
    FRONT2_LAUNCHES += 1
    return y[0], y[1]


def fft_vmem(x: Cplx, sign: int, scale: float = 1.0) -> Cplx:
    """scale * DFT_sign over the last axis of split float32 planes (..., n),
    n in ``supported``, by ``route(n)``."""
    re, im, n = _rows_2d("fft_vmem", x, sign)
    r = route(n)
    dev = _check_rows("fft_vmem", re, im)
    if dev.type == "cpu":
        return fft_vmem_plain(x, sign, scale)
    return _launch(re, im, x[0].shape, r, sign, float(scale), dev)


def _front2_route(n: int, split: Optional[Split]) -> Route:
    if split is None and n not in FRONT2_SIZES:
        raise ValueError(f"fft_vmem_front2: no default split for size {n} "
                         f"(defaults exist for {FRONT2_SIZES}); pass split=(n1, n2)")
    return route(n, split)


def fft_vmem_front2(x: Cplx, sign: int, scale: float = 1.0,
                    split: Optional[Split] = None) -> Cplx:
    """scale * DFT_sign over the last axis of split float32 planes (..., n):
    n in ``FRONT2_SIZES`` by ``route(n)``, or any supported n as the
    two-pass four-step at ``split``."""
    re, im, n = _rows_2d("fft_vmem_front2", x, sign)
    r = _front2_route(n, split)
    dev = _check_rows("fft_vmem_front2", re, im)
    if dev.type == "cpu":
        return fft_vmem_front2_plain(x, sign, scale, split)
    return _launch(re, im, x[0].shape, r, sign, float(scale), dev)


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
        z = exact_matmul(torch.cat([re, im], -1), _dft_stack(n, sign, re.device))
        return z[..., :n], z[..., n:]
    l1 = LEAF_MAX
    return _four_step_plain(re, im, sign, l1, n // l1)


def _four_step_plain(re, im, sign, n1, n2) -> Cplx:
    lead = re.shape[:-1]
    n = n1 * n2
    # columns j2 of the (n1, n2) matrix as rows, transformed over j1
    ar, ai = _dft_plain(re.reshape(lead + (n1, n2)).transpose(-1, -2),
                        im.reshape(lead + (n1, n2)).transpose(-1, -2), sign)
    ar, ai = ar.transpose(-1, -2), ai.transpose(-1, -2)        # (..., k1, j2)
    tr, ti = _four_table(n1, n2, sign, re.device)
    br, bi = ar * tr - ai * ti, ar * ti + ai * tr
    zr, zi = _dft_plain(br, bi, sign)                          # (..., k1, k2)
    return (zr.transpose(-1, -2).reshape(lead + (n,)),
            zi.transpose(-1, -2).reshape(lead + (n,)))


def _plain(x: Cplx, sign: int, scale: float, r: Route) -> Cplx:
    re, im = (p.to(torch.float32) for p in x)
    if r.kind == "rows":
        yr, yi = _dft_plain(re, im, sign)
    else:
        yr, yi = _four_step_plain(re, im, sign, r.n1, r.n2)
    return yr * scale, yi * scale


def fft_vmem_plain(x: Cplx, sign: int, scale: float = 1.0) -> Cplx:
    """Plain PyTorch twin of ``fft_vmem``: the factorization of
    ``route(n)``; scale applied once, last."""
    _, _, n = _check("fft_vmem", x, sign)
    return _plain(x, sign, scale, route(n))


def fft_vmem_front2_plain(x: Cplx, sign: int, scale: float = 1.0,
                          split: Optional[Split] = None) -> Cplx:
    """Plain PyTorch twin of ``fft_vmem_front2``: the factorization of its
    route; scale applied once, last."""
    _, _, n = _check("fft_vmem_front2", x, sign)
    return _plain(x, sign, scale, _front2_route(n, split))
