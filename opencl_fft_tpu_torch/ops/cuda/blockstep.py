"""Fused per-block streaming steps: the CUDA kernels of ``csrc/blockstep.cu``
and their plain PyTorch twins.

Counterparts of ``opencl_fft_tpu/ops/pallas/blockstep.py``:

- ``block_step_fused``: the MAC of ``ops/cuda/mac.spectral_mac`` at ring
  row ``rp``, then y, the inverse real transform of the accumulator
  (unpack + inverse DFT + deinterleave: the JAX kernel's product against
  the (2b, 2b) ``wpost`` table), out = (y[:b] + tail) / pts and new_tail =
  y[b:].
- ``block_step_fwd_fused``: the new block's frame (its packed forward
  transform: the JAX kernel's product against the (pts, 2b) ``wfwd``
  table), written into ring slot wp = (rp - 1) mod nparts (both halves of
  the doubled ring), then ``block_step_fused`` at rp.
- ``block_step_fwd_fused_tv``: both operands' frames; the input frame as
  above, the coefficient frame into h row ``wp2``.
- ``block_mac_unpack``: z = ``rfft.unpack_inverse`` of the MAC at ring row
  ``rp``, the input of the half-size inverse FFT, which the per-block
  functions take above pts 2048 (``ops/pconv._mac_unpack_kernel``). One
  launch of ``spectral_mac``'s kernel at its plan (``mac.mac_plan``), so
  the accumulator is that kernel's bit for bit: a cluster's tile holds bin
  pairs (k, M - k), both accumulators of a pair stay on chip, and one
  thread unpacks each pair with the twiddle table of
  ``tables.unpack_twiddle``. The TPU kernel's one-hot flip product, aligned
  DMA and rotate switch are VMEM workarounds and its shape gates (nparts %
  8, bins % 128) do not apply: any nparts >= 1 and bins >= 2.

The kernels compute both transforms as m-point FFTs (m = pts) inside a CTA,
the whole scans' chain (``ops/cuda/streamstep.py``): the forward is the
scans' own kernel, the FFT of z_j = x_2j + i x_2j+1 and the pack with the
forward coefficient stack; the inverse unpacks the accumulator with the
inverse stack and transforms it once, its first m/2 values (deinterleaved)
being y[:b] and the rest y[b:]. So they read no dense table, and take a
power-of-two pts in [2, ``STEP_MAX_PTS``]; ``step_plan`` shapes their
tiles. The twins follow the same chain in plain PyTorch (``torch.fft``:
``streamstep._fft_frames``, ``streamstep._unpack_ifft``); the JAX kernels'
dense-table chain stays as the tests' oracle (``tables._wfwd_np``,
``_wpost_np``, ``streamstep._dense_frames``, ``_post_ola_plain``).

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

import functools
from typing import Optional, Tuple

import torch

from ...utils.numerics import is_pow2
from ..cplx import Cplx
from ..rfft import unpack_inverse
from . import _build
from .mac import check_ring, launch, mac_plan, part_scratch, spectral_mac_plain
from .streamstep import TILE_LOG2, _aligned8, _fft_frames, _unpack_ifft
from .tables import coef_tables, unpack_twiddle
from .vmemfft import pass_twiddle_np

STEP_LAUNCHES = 0
FWD_LAUNCHES = 0
FWD_TV_LAUNCHES = 0
MAC_UNPACK_LAUNCHES = 0

STEP_MAX_PTS = 1 << (TILE_LOG2 + 1)   # the in-CTA transform's largest (one row a CTA)


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


def step_plan(pts: int) -> Tuple[int, int]:
    """log2 rows a CTA of the kernels' transform tiles: (forward, inverse).

    The forward takes 2^11 values a CTA (at least one row; rows past the
    last block are zero): 128 threads share a block's pack, and more rows
    only add transforms. The inverse takes a channel a CTA on row 0 of a
    tile of up to 16 rows and 2^13 values (one row of 2^14 at pts 2^14),
    the other rows zero: its first step adds up to 32 slices' partials of
    each bin, which one row's pts / 16 threads could not issue at once;
    16 rows give each bin a thread. Chosen by timing on the H100 against
    2^9 and 2^13 values a CTA and the scans' tile in the forward, 2^11 and
    2^12 values and several channels a CTA in the inverse (PERF.md §6)."""
    log_l = pts.bit_length() - 1
    return max(11 - log_l, 0), max(min(TILE_LOG2 - log_l, 4), 0)


@functools.lru_cache(maxsize=None)
def _pass_tables(pts: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The in-CTA transforms' pass tables of pts (``vmemfft.pass_twiddle_np``)
    for sign -1 and +1 on ``device``."""
    return tuple(torch.from_numpy(pass_twiddle_np(pts, sign)).to(device) for sign in (-1, 1))


def _card_tables(name: str, pts: int, forward: bool, dev: torch.device):
    """(tensors, ints) every step kernel takes after its own planes: the
    forward (where it has one) and inverse pass tables and coefficient
    stacks; the tiles of ``step_plan``."""
    if not is_pow2(pts) or not 2 <= pts <= STEP_MAX_PTS:
        raise ValueError(f"{name}: the kernels take a power-of-two pts in [2, "
                         f"{STEP_MAX_PTS}], got {pts}")
    (twf, twi), (fc, ic) = _pass_tables(pts, dev), coef_tables(pts, dev)
    fwd, inv = step_plan(pts)
    return ((twf, fc, twi, ic), (fwd, inv)) if forward else ((twi, ic), (inv,))


def _frames(blocks: torch.Tensor, pts: int) -> Cplx:
    """Forward frames of blocks (..., pts), the kernels' chain
    (``streamstep._fft_frames``): split (..., bins)."""
    fr, fi = _fft_frames(blocks.reshape(1, -1, pts), pts)          # (N, 1, bins)
    return fr.reshape(blocks.shape), fi.reshape(blocks.shape)


def _post(acc: Cplx, tail: torch.Tensor, pts: int):
    """(out, new_tail) of an accumulator ([C,] bins), the kernels' chain:
    y = IFFT_m(U(acc)) unnormalized (``streamstep._unpack_ifft``), all m
    values deinterleaved into 2 pts samples; out = (y[:pts] + tail) / pts,
    new_tail = y[pts:]."""
    y = _unpack_ifft(*acc, pts)
    time = torch.stack([y.real, y.imag], -1).reshape(*y.shape[:-1], 2 * pts)
    return (time[..., :pts] + tail) / pts, time[..., pts:].contiguous()


def block_step_fused_plain(x2: Cplx, h: Cplx, rp: int, b0_scale: float,
                           tail: torch.Tensor, pts: int):
    """Plain PyTorch twin of ``block_step_fused``: ``spectral_mac_plain``,
    then the inverse chain and the overlap-add (``_post``)."""
    return _post(spectral_mac_plain(x2, h, rp, b0_scale), tail, pts)


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
    tabs, plan = _card_tables("block_step_fused", pts, False, dev)
    out, new_tail = torch.empty_like(tail), torch.empty_like(tail)
    launch("block_step_fused_f32",
           (*x2, *h, *tabs, tail, out, new_tail, part_scratch(nch, nparts, pts, dev)),
           (nch, nparts, pts, rp, *plan), b0_scale, dev)
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
    """Plain PyTorch twin of ``block_step_fwd_fused``: the frame by the
    forward chain (``_frames``), the new ring, then
    ``block_step_fused_plain``."""
    nparts = h[0].shape[-2]
    wp = (rp - 1) % nparts
    x2n = tuple(_with_row(p, f, wp, wp + nparts) for p, f in zip(x2, _frames(block, pts)))
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
    tabs, plan = _card_tables("block_step_fwd_fused", pts, True, dev)
    out, new_tail = torch.empty_like(tail), torch.empty_like(tail)
    nx = torch.empty_like(x2[0]), torch.empty_like(x2[1])
    frames = torch.empty((nch, 1, 2 * pts), dtype=torch.float32, device=dev)
    launch("block_step_fwd_fused_f32",
           (_aligned8(block), *x2, *h, *tabs, tail, out, new_tail, *nx, frames,
            part_scratch(nch, nparts, pts, dev)),
           (nch, nparts, pts, rp, *plan), b0_scale, dev)
    FWD_LAUNCHES += 1
    return out, new_tail, nx


def block_step_fwd_fused_tv_plain(blocks: torch.Tensor, x2: Cplx, h: Cplx, rp: int,
                                  wp2: int, b0_scale: float, tail: torch.Tensor, pts: int):
    """Plain PyTorch twin of ``block_step_fwd_fused_tv``: both frames by the
    forward chain, the new rings, then ``block_step_fused_plain``."""
    nparts = h[0].shape[-2]
    fr, fi = _frames(blocks, pts)                                    # (2, [C,] bins)
    wp = (rp - 1) % nparts
    x2n = tuple(_with_row(p, f[0], wp, wp + nparts) for p, f in zip(x2, (fr, fi)))
    hn = tuple(_with_row(p, f[1], wp2) for p, f in zip(h, (fr, fi)))
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
    tabs, plan = _card_tables("block_step_fwd_fused_tv", pts, True, dev)
    out, new_tail = torch.empty_like(tail), torch.empty_like(tail)
    nx = torch.empty_like(x2[0]), torch.empty_like(x2[1])
    nh = torch.empty_like(h[0]), torch.empty_like(h[1])
    frames = torch.empty((nch, 2, 2 * pts), dtype=torch.float32, device=dev)
    launch("block_step_fwd_fused_tv_f32",
           (_aligned8(blocks), *x2, *h, *tabs, tail, out, new_tail, *nx, *nh, frames,
            part_scratch(nch, nparts, pts, dev)),
           (nch, nparts, pts, rp, wp2, *plan), b0_scale, dev)
    FWD_TV_LAUNCHES += 1
    return out, new_tail, nx, nh


def block_mac_unpack_plain(x2: Cplx, h: Cplx, rp: int, b0_scale: float) -> Cplx:
    """Plain PyTorch twin of ``block_mac_unpack``: ``spectral_mac_plain``,
    then ``rfft.unpack_inverse``."""
    return unpack_inverse(spectral_mac_plain(x2, h, rp, b0_scale))


def block_mac_unpack(x2: Cplx, h: Cplx, rp: int, b0_scale: float,
                     rp_at: Optional[torch.Tensor] = None) -> Cplx:
    """The MAC of one block and the inverse unpack: x2 split doubled ring
    ([C,] 2*nparts, bins), h split ([C,] nparts, bins), rp an int in [0,
    nparts), bins >= 2. Returns split ([C,] bins), the input of the
    half-size inverse FFT (``fft_split(z, +1)``, then ``interleave``).

    ``rp_at``: an int32 tensor of one element on the planes' device, or
    None. Where given, the window starts at the row it holds when the
    kernel runs (the twin reads it at the call), so a CUDA graph that
    captured the launch reads the row of each replay; rp is then only
    checked."""
    global MAC_UNPACK_LAUNCHES
    nch, nparts, bins = check_ring("block_mac_unpack", x2, h, rp)
    if bins < 2:
        raise ValueError(f"block_mac_unpack: bins must be >= 2, got {bins}")
    if rp_at is not None and (rp_at.dtype != torch.int32 or rp_at.numel() != 1
                              or rp_at.device != x2[0].device):
        raise ValueError("block_mac_unpack: rp_at must be one int32 on the planes' device")
    dev = _build.launch_device("block_mac_unpack", (*x2, *h))
    if dev.type == "cpu":
        return block_mac_unpack_plain(x2, h, rp if rp_at is None else int(rp_at), b0_scale)
    zr = torch.empty((*x2[0].shape[:-2], bins), dtype=torch.float32, device=dev)
    zi = torch.empty_like(zr)
    launch("block_mac_unpack_f32", (*x2, *h, *unpack_twiddle(bins, dev), zr, zi, rp_at),
           (nch, nparts, bins, rp, *mac_plan(nparts, bins)), b0_scale, dev)
    MAC_UNPACK_LAUNCHES += 1
    return zr, zi
