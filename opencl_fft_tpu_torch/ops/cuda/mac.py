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

The kernel is one launch (``mac_cluster_kernel``): a thread-block cluster
cuts the partitions of a tile of bins into slices, keeps each slice's
partial sums in its CTAs' shared memory and adds them in slice order over
distributed shared memory. ``mac_plan`` shapes it; ``block_mac_unpack``
(``ops/cuda/blockstep.py``) runs the same kernel and plan with the inverse
unpack after the sum.

``spectral_mac`` runs the CUDA kernel for CUDA tensors and the twin for CPU
tensors; anything else raises, and a build or launch failure raises.
``LAUNCHES`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..cplx import Cplx
from . import _build

LAUNCHES = 0

# Most partition slices per channel in the block steps' MAC (``MAC_SLICES``
# of csrc/blockstep.cu): the partial-sum scratch holds this many rows a
# channel.
MAC_SLICES = 32

CLUSTER_PORTABLE = 8    # CTAs a cluster that every Hopper card launches
CLUSTER_THREADS = 512   # most threads a CTA of mac_cluster_kernel
SLICE_PARTS = 8         # fewest partitions a slice the plan aims at
CHANNEL_THREADS = 1 << 16   # (bin, slice) threads the plan gives one channel
CHANNEL_CTAS = 256      # CTAs of one channel a tile still leaves: ~2 an SM of 132


class ClusterPlan(NamedTuple):
    """The one-launch MAC's shape (``csrc/blockstep.cu`` ClusterPlan): a
    cluster of ``cluster`` CTAs, each of ``ways`` thread groups of ``tile``
    threads (one column of bins each); slice rank * ways + way of
    ``qchunk`` partitions to group ``way`` of CTA ``rank``."""
    cluster: int
    ways: int
    qchunk: int
    tile: int


@functools.lru_cache(maxsize=None)
def mac_plan(nparts: int, bins: int) -> ClusterPlan:
    """The plan of ``spectral_mac`` and ``block_mac_unpack`` at (nparts,
    bins). It takes no channel count and no kernel, so the two kernels cut
    the partitions alike (``block_mac_unpack`` is ``unpack_inverse`` of
    ``spectral_mac`` bit for bit) and one channel's bits do not depend on
    how many share the call.

    Slices of at least ~SLICE_PARTS partitions, at most MAC_SLICES, and
    about CHANNEL_THREADS (bin, slice) threads a channel: 32 slices of 8 at
    bins 512, 16 of 16 at bins 4096. Up to CLUSTER_PORTABLE slices go to
    the CTAs of a cluster, the rest to thread groups inside each CTA; the
    tile of bins is the widest that still leaves CHANNEL_CTAS CTAs a
    channel. Chosen on the H100 against 13–18 other plans at the main
    paths' shapes (PERF.md §6, PR 14): more slices cost a channel-16 call
    ~25% at bins 4096, fewer cost a one-channel call at bins 512 ~2x."""
    slices = max(1, min(-(-nparts // SLICE_PARTS), MAC_SLICES, CHANNEL_THREADS // bins))
    cluster = min(slices, CLUSTER_PORTABLE)
    ways = -(-slices // cluster)
    qchunk = -(-nparts // (cluster * ways))
    tile = 32
    while 2 * tile * ways <= CLUSTER_THREADS and -(-bins // (2 * tile)) * cluster >= CHANNEL_CTAS:
        tile *= 2
    return ClusterPlan(cluster, ways, qchunk, tile)


@functools.lru_cache(maxsize=None)
def _entry(name: str, npointers: int, nints: int):
    fn = getattr(_build.load("blockstep"), name)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * npointers + [i] * nints + [ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, tensors: Sequence[Optional[torch.Tensor]], ints: Sequence[int],
           b0_scale: float, dev: torch.device) -> None:
    """Call the C entry ``name`` of csrc/blockstep.cu on the current stream
    of ``dev``: the tensors' pointers (null for None), the ints, b0, the
    device; raise on a CUDA error at launch."""
    fn = _entry(name, len(tensors), len(ints))
    err = fn(*(None if t is None else t.data_ptr() for t in tensors), *ints,
             float(b0_scale), dev.index, torch.cuda.current_stream(dev).cuda_stream)
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
    """The block steps' partial-sum scratch (C, min(nparts, MAC_SLICES),
    2*bins)."""
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
    launch("spectral_mac_f32", (*x2, *h, accr, acci),
           (nch, nparts, bins, rp, *mac_plan(nparts, bins)), b0_scale, dev)
    LAUNCHES += 1
    return accr, acci
