"""Fused per-block streaming steps: the CUDA kernels of ``csrc/blockstep.cu``
and their plain PyTorch twins.

Counterparts of ``opencl_fft_tpu/ops/pallas/blockstep.py``:

- ``block_step_fused``: the MAC of ``ops/cuda/mac.spectral_mac`` at ring
  row ``rp``, then y = [acc_re | acc_im] @ wpost (the (2b, 2b) table of
  unpack + inverse DFT + deinterleave), out = (y[:b] + tail) / pts and
  new_tail = y[b:].
- ``block_step_fwd_fused``: the new block's frame F = block @ wfwd (the
  (pts, 2b) forward table), written into ring slot wp = (rp - 1) mod nparts
  (both halves of the doubled ring), then ``block_step_fused`` at rp.
- ``block_step_fwd_fused_tv``: both operands' frames from one 2-row product;
  the input frame as above, the coefficient frame into h row ``wp2``.
- ``block_mac_unpack``: z = ``rfft.unpack_inverse`` of the MAC at ring row
  ``rp``, the input of the half-size inverse FFT. It serves partitions whose
  dense post table is too large to build (pts > 2048). The MAC's kernel and
  its slice-order reduce are ``spectral_mac``'s, so the accumulator is that
  kernel's bit for bit; one thread unpacks each bin pair (k, M - k) with
  the twiddle table of ``tables.unpack_twiddle``. The TPU kernel's one-hot
  flip product, aligned DMA and rotate switch are VMEM workarounds and its
  shape gates (nparts % 8, bins % 128) do not apply: any nparts >= 1 and
  bins >= 2.

Where the JAX kernels return the fresh frames for the caller to write, these
return the new rings: the kernel writes the given ring with the fresh rows
into a new one from the loads its MAC makes (the per-block functions return
new state and leave the given state untouched). Planes may carry a leading
channel axis C (a batched state with shared ring pointers); the channel is
a grid dimension of the kernels. Every output plane is contiguous.

Each wrapper runs its CUDA kernel for CUDA tensors and its twin for CPU
tensors; anything else raises, and a build or launch failure raises.
``STEP_LAUNCHES``, ``FWD_LAUNCHES``, ``FWD_TV_LAUNCHES`` and
``MAC_UNPACK_LAUNCHES`` count the kernel launches of ``block_step_fused``,
``block_step_fwd_fused``, ``block_step_fwd_fused_tv`` and
``block_mac_unpack``.
"""

from __future__ import annotations

import torch

from ..cplx import Cplx
from ..rfft import unpack_inverse
from . import _build
from .mac import check_ring, launch, part_scratch, spectral_mac_plain
from .tables import fwd_table, post_table, unpack_twiddle

STEP_LAUNCHES = 0
FWD_LAUNCHES = 0
FWD_TV_LAUNCHES = 0
MAC_UNPACK_LAUNCHES = 0


def _check_step(name: str, x2: Cplx, h: Cplx, rp: int, tail: torch.Tensor, pts: int):
    """The ring checks of ``check_ring``, bins == pts and tail ([C,] pts);
    returns (C, nparts)."""
    nch, nparts, bins = check_ring(name, x2, h, rp)
    if bins != pts:
        raise ValueError(f"{name}: bins ({bins}) must equal pts ({pts})")
    want = (*h[0].shape[:-2], pts)
    if tuple(tail.shape) != want:
        raise ValueError(f"{name}: tail must be {want}, got {tuple(tail.shape)}")
    return nch, nparts


def _scratch(nch: int, nparts: int, pts: int, dev: torch.device):
    """The kernels' partial sums and (C, 2b) accumulator rows."""
    return (part_scratch(nch, nparts, pts, dev),
            torch.empty((nch, 2 * pts), dtype=torch.float32, device=dev))


def block_step_fused_plain(x2: Cplx, h: Cplx, rp: int, b0_scale: float,
                           tail: torch.Tensor, pts: int):
    """Plain PyTorch twin of ``block_step_fused``: ``spectral_mac_plain``,
    one product against the post table and the overlap-add."""
    acc_r, acc_i = spectral_mac_plain(x2, h, rp, b0_scale)
    y = torch.cat([acc_r, acc_i], -1) @ post_table(pts, acc_r.device)
    return (y[..., :pts] + tail) / pts, y[..., pts:].contiguous()


def block_step_fused(x2: Cplx, h: Cplx, rp: int, b0_scale: float, tail: torch.Tensor,
                     pts: int):
    """MAC + inverse transform + overlap-add of one block: x2 split doubled
    ring ([C,] 2*nparts, bins), h split ([C,] nparts, bins), rp an int in
    [0, nparts), tail ([C,] pts), bins == pts. Returns (out, new_tail), both
    ([C,] pts)."""
    global STEP_LAUNCHES
    nch, nparts = _check_step("block_step_fused", x2, h, rp, tail, pts)
    dev = _build.launch_device("block_step_fused", (*x2, *h, tail))
    if dev.type == "cpu":
        return block_step_fused_plain(x2, h, rp, b0_scale, tail, pts)
    out, new_tail = torch.empty_like(tail), torch.empty_like(tail)
    launch("block_step_fused_f32",
           (*x2, *h, post_table(pts, dev), tail, out, new_tail,
            *_scratch(nch, nparts, pts, dev)),
           (nch, nparts, pts, rp), b0_scale, dev)
    STEP_LAUNCHES += 1
    return out, new_tail


def _with_row(plane: torch.Tensor, row: torch.Tensor, *at: int) -> torch.Tensor:
    """A copy of ``plane`` (..., rows, bins) whose rows ``at`` hold ``row``."""
    plane = plane.clone()
    for r in at:
        plane[..., r, :] = row
    return plane


def block_step_fwd_fused_plain(block: torch.Tensor, x2: Cplx, h: Cplx, rp: int,
                               b0_scale: float, tail: torch.Tensor, pts: int):
    """Plain PyTorch twin of ``block_step_fwd_fused``: the frame from the
    forward table, the new ring, then ``block_step_fused_plain``."""
    nparts = h[0].shape[-2]
    f = block.to(torch.float32) @ fwd_table(pts, block.device)
    wp = (rp - 1) % nparts
    x2n = tuple(_with_row(p, f[..., i * pts:(i + 1) * pts], wp, wp + nparts)
                for i, p in enumerate(x2))
    return (*block_step_fused_plain(x2n, h, rp, b0_scale, tail, pts), x2n)


def block_step_fwd_fused(block: torch.Tensor, x2: Cplx, h: Cplx, rp: int,
                         b0_scale: float, tail: torch.Tensor, pts: int):
    """One whole LTI block: forward transform of block ([C,] pts), its frame
    written into ring slot wp = (rp - 1) mod nparts of a new doubled ring,
    then ``block_step_fused`` at rp over the new ring. x2 is the ring before
    the write; rp = (wp + 1) mod nparts is the post-increment pointer.
    Returns (out, new_tail, new x2), the ring split ([C,] 2*nparts, bins)."""
    global FWD_LAUNCHES
    nch, nparts = _check_step("block_step_fwd_fused", x2, h, rp, tail, pts)
    if tuple(block.shape) != tuple(tail.shape):
        raise ValueError(f"block_step_fwd_fused: block must be {tuple(tail.shape)}, got "
                         f"{tuple(block.shape)}")
    dev = _build.launch_device("block_step_fwd_fused", (block, *x2, *h, tail))
    if dev.type == "cpu":
        return block_step_fwd_fused_plain(block, x2, h, rp, b0_scale, tail, pts)
    out, new_tail = torch.empty_like(tail), torch.empty_like(tail)
    nx = torch.empty_like(x2[0]), torch.empty_like(x2[1])
    frames = torch.empty((nch, 2 * pts), dtype=torch.float32, device=dev)
    launch("block_step_fwd_fused_f32",
           (block, *x2, *h, fwd_table(pts, dev), post_table(pts, dev), tail, out, new_tail,
            *nx, frames, *_scratch(nch, nparts, pts, dev)),
           (nch, nparts, pts, rp), b0_scale, dev)
    FWD_LAUNCHES += 1
    return out, new_tail, nx


def block_step_fwd_fused_tv_plain(blocks: torch.Tensor, x2: Cplx, h: Cplx, rp: int,
                                  wp2: int, b0_scale: float, tail: torch.Tensor, pts: int):
    """Plain PyTorch twin of ``block_step_fwd_fused_tv``: both frames from
    one product against the forward table, the new rings, then
    ``block_step_fused_plain``."""
    nparts = h[0].shape[-2]
    f = blocks.to(torch.float32) @ fwd_table(pts, blocks.device)     # (2, [C,] 2b)
    wp = (rp - 1) % nparts
    x2n = tuple(_with_row(p, f[0, ..., i * pts:(i + 1) * pts], wp, wp + nparts)
                for i, p in enumerate(x2))
    hn = tuple(_with_row(p, f[1, ..., i * pts:(i + 1) * pts], wp2) for i, p in enumerate(h))
    return (*block_step_fused_plain(x2n, hn, rp, b0_scale, tail, pts), x2n, hn)


def block_step_fwd_fused_tv(blocks: torch.Tensor, x2: Cplx, h: Cplx, rp: int, wp2: int,
                            b0_scale: float, tail: torch.Tensor, pts: int):
    """One whole time-varying block: blocks (2, [C,] pts), the input then
    the coefficient operand. The input frame goes into a new doubled ring
    as in ``block_step_fwd_fused``, the coefficient frame into h row wp2 (an
    int in [0, nparts), the pre-decrement pointer) of a new coefficient
    ring, then ``block_step_fused`` at rp over both new rings. Returns (out,
    new_tail, new x2, new h)."""
    global FWD_TV_LAUNCHES
    nch, nparts = _check_step("block_step_fwd_fused_tv", x2, h, rp, tail, pts)
    if tuple(blocks.shape) != (2, *tail.shape):
        raise ValueError(f"block_step_fwd_fused_tv: blocks must be {(2, *tail.shape)}, got "
                         f"{tuple(blocks.shape)}")
    if not isinstance(wp2, int) or not 0 <= wp2 < nparts:
        raise ValueError(f"block_step_fwd_fused_tv: wp2 must be an int in [0, {nparts}), "
                         f"got {wp2!r}")
    dev = _build.launch_device("block_step_fwd_fused_tv", (blocks, *x2, *h, tail))
    if dev.type == "cpu":
        return block_step_fwd_fused_tv_plain(blocks, x2, h, rp, wp2, b0_scale, tail, pts)
    out, new_tail = torch.empty_like(tail), torch.empty_like(tail)
    nx = torch.empty_like(x2[0]), torch.empty_like(x2[1])
    nh = torch.empty_like(h[0]), torch.empty_like(h[1])
    frames = torch.empty((2 * nch, 2 * pts), dtype=torch.float32, device=dev)
    launch("block_step_fwd_fused_tv_f32",
           (blocks, *x2, *h, fwd_table(pts, dev), post_table(pts, dev), tail, out, new_tail,
            *nx, *nh, frames, *_scratch(nch, nparts, pts, dev)),
           (nch, nparts, pts, rp, wp2), b0_scale, dev)
    FWD_TV_LAUNCHES += 1
    return out, new_tail, nx, nh


def block_mac_unpack_plain(x2: Cplx, h: Cplx, rp: int, b0_scale: float) -> Cplx:
    """Plain PyTorch twin of ``block_mac_unpack``: ``spectral_mac_plain``,
    then ``rfft.unpack_inverse``."""
    return unpack_inverse(spectral_mac_plain(x2, h, rp, b0_scale))


def block_mac_unpack(x2: Cplx, h: Cplx, rp: int, b0_scale: float) -> Cplx:
    """The MAC of one block and the inverse unpack: x2 split doubled ring
    ([C,] 2*nparts, bins), h split ([C,] nparts, bins), rp an int in [0,
    nparts), bins >= 2. Returns split ([C,] bins), the input of the
    half-size inverse FFT (``fft_split(z, +1)``, then ``interleave``)."""
    global MAC_UNPACK_LAUNCHES
    nch, nparts, bins = check_ring("block_mac_unpack", x2, h, rp)
    if bins < 2:
        raise ValueError(f"block_mac_unpack: bins must be >= 2, got {bins}")
    dev = _build.launch_device("block_mac_unpack", (*x2, *h))
    if dev.type == "cpu":
        return block_mac_unpack_plain(x2, h, rp, b0_scale)
    zr = torch.empty((*x2[0].shape[:-2], bins), dtype=torch.float32, device=dev)
    zi = torch.empty_like(zr)
    launch("block_mac_unpack_f32",
           (*x2, *h, *unpack_twiddle(bins, dev), zr, zi, part_scratch(nch, nparts, bins, dev)),
           (nch, nparts, bins, rp), b0_scale, dev)
    MAC_UNPACK_LAUNCHES += 1
    return zr, zi
