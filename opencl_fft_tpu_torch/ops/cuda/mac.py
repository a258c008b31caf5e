"""One-block frequency-delay-line MAC over the doubled input ring: the CUDA
kernel of ``csrc/blockstep.cu`` (``spectral_mac_f32``) and its plain
PyTorch twin.

Counterpart of ``opencl_fft_tpu/ops/pallas/mac.py`` ``spectral_mac``:

    acc[k] = sum_{q < nparts} x2[rp + q, k] (*) h[q, k]

a complex product per bin, except at bin 0 (the packed (DC/2, Nyq/2) pair),
which multiplies componentwise and is scaled by ``b0_scale``
(cl_conv_kernels.h:102-118). The window is one row slice of the doubled
ring, rows [rp, rp + nparts). Planes may carry a leading channel axis C
(a batched state with a shared ``rp``); the channel is a grid dimension of
the kernel. The TPU kernel's shape rules (nparts a multiple of 8, bins of
128) are VMEM rules and do not apply.

``spectral_mac`` runs the CUDA kernel for CUDA tensors and the twin for CPU
tensors; anything else raises, and a build or launch failure raises.
``LAUNCHES`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from ..cplx import Cplx
from . import _build

LAUNCHES = 0

# Most partition slices per channel in the kernel's MAC (``MAC_SLICES`` of
# csrc/blockstep.cu): the partial-sum scratch holds this many rows a channel.
MAC_SLICES = 32


@functools.lru_cache(maxsize=None)
def _entry(name: str, npointers: int, nints: int):
    fn = getattr(_build.load("blockstep"), name)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * npointers + [i] * nints + [ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, tensors: Sequence[torch.Tensor], ints: Sequence[int],
           b0_scale: float, dev: torch.device) -> None:
    """Call the C entry ``name`` of csrc/blockstep.cu on the current stream
    of ``dev``: the tensors' pointers, the ints, b0, the device; raise on a
    CUDA error at launch."""
    fn = _entry(name, len(tensors), len(ints))
    err = fn(*(t.data_ptr() for t in tensors), *ints, float(b0_scale), dev.index,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def check_ring(name: str, x2: Cplx, h: Cplx, rp: int) -> Tuple[int, int, int]:
    """x2 planes ([C,] 2*nparts, bins), h planes ([C,] nparts, bins), one
    shape each, and 0 <= rp < nparts; returns (C, nparts, bins), C = 1
    without a channel axis."""
    (xr, xi), (hr, hi) = x2, h
    if hr.dim() not in (2, 3) or tuple(hi.shape) != tuple(hr.shape):
        raise ValueError(f"{name}: h planes must be one ([C,] nparts, bins) shape, got "
                         f"{tuple(hr.shape)} and {tuple(hi.shape)}")
    *lead, nparts, bins = hr.shape
    want = (*lead, 2 * nparts, bins)
    if tuple(xr.shape) != want or tuple(xi.shape) != want:
        raise ValueError(f"{name}: doubled-ring planes must be {want}, got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    if not isinstance(rp, int) or not 0 <= rp < nparts:
        raise ValueError(f"{name}: rp must be an int in [0, {nparts}), got {rp!r}")
    return (lead[0] if lead else 1), nparts, bins


def part_scratch(nch: int, nparts: int, bins: int, dev: torch.device) -> torch.Tensor:
    """The kernel's partial-sum scratch (C, min(nparts, MAC_SLICES), 2*bins)."""
    return torch.empty((nch, min(nparts, MAC_SLICES), 2 * bins), dtype=torch.float32,
                       device=dev)


def spectral_mac_plain(x2: Cplx, h: Cplx, rp: int, b0_scale: float) -> Cplx:
    """Plain PyTorch twin of ``spectral_mac``: the window rows [rp, rp +
    nparts) times h, bin 0 componentwise times b0, summed over the
    partitions."""
    (xr, xi), (hr, hi) = x2, h
    nparts = hr.shape[-2]
    wr, wi = xr[..., rp:rp + nparts, :], xi[..., rp:rp + nparts, :]
    acc_r = torch.sum(wr * hr - wi * hi, dim=-2)
    acc_i = torch.sum(wr * hi + wi * hr, dim=-2)
    acc_r[..., 0] = b0_scale * torch.sum(wr[..., 0] * hr[..., 0], dim=-1)
    acc_i[..., 0] = b0_scale * torch.sum(wi[..., 0] * hi[..., 0], dim=-1)
    return acc_r, acc_i


def spectral_mac(x2: Cplx, h: Cplx, rp: int, b0_scale: float) -> Cplx:
    """acc[k] = sum_q x2[rp + q, k] (*) h[q, k]: x2 split doubled ring
    ([C,] 2*nparts, bins), h split ([C,] nparts, bins), rp an int in [0,
    nparts). Returns split ([C,] bins)."""
    global LAUNCHES
    nch, nparts, bins = check_ring("spectral_mac", x2, h, rp)
    dev = _build.launch_device("spectral_mac", (*x2, *h))
    if dev.type == "cpu":
        return spectral_mac_plain(x2, h, rp, b0_scale)
    accr = torch.empty((*x2[0].shape[:-2], bins), dtype=torch.float32, device=dev)
    acci = torch.empty_like(accr)
    launch("spectral_mac_f32", (*x2, *h, accr, acci, part_scratch(nch, nparts, bins, dev)),
           (nch, nparts, bins, rp), b0_scale, dev)
    LAUNCHES += 1
    return accr, acci
