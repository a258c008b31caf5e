"""Whole-scan streaming convolution on the factored transform tables, LTI
and time-varying, for one channel or many: the CUDA kernels of
``csrc/splitstep.cu`` and their plain PyTorch twins.

Counterparts of ``opencl_fft_tpu/ops/pallas/splitstep.py``
``stream_steps_fused_split`` and ``stream_steps_fused_split_tv``: the scans
of ``ops/cuda/streamstep.py`` (same arguments, same results within float32
rounding) with both transform chains factored through one (pts, pts) table
``ctab`` and two (8, pts) coefficient stacks (``tables.split_tables``)
instead of the dense (pts, 2 pts) and (2 pts, 2 pts) tables, which grow to
400 MB at pts 4096. The engine (``ops/pconv.py``) runs them above
``_FWD_MM_MAX_PTS``; the wrappers take any power-of-two pts >= 2.

The single-channel wrappers are the C = 1 case of the batched ones; the
batched scans take blocks (nblocks, C, pts) and, in the TV scan, one ring
pointer shared by every channel or one each. Each wrapper runs its CUDA
kernel for CUDA tensors and its twin for CPU tensors; anything else raises.
The twins are the JAX package's factored chains (``fwd_ref``, ``inv_ref``)
around the dense scan twins' MAC. ``LAUNCHES`` counts launches of the LTI
kernel, ``TV_LAUNCHES`` of the TV kernel, through any of the wrappers.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...utils.numerics import is_pow2
from ..cplx import Cplx
from . import _build
from .streamstep import (Pointers, _channel_pointers, _check, _check_batched, _one, _ptrs,
                         _slot_table, _lti_scan_plain, _tv_scan_plain)
from .tables import split_tables

LAUNCHES = 0
TV_LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("splitstep").stream_steps_fused_split_batched_f32
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 16 + [i, i, i, i, ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _tv_kernel():
    fn = _build.load("splitstep").stream_steps_fused_split_batched_tv_f32
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 7 + [i] + [p] * 14 + [i, i, i, i, ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


def _check_pts(pts: int):
    if not is_pow2(pts) or pts < 2:
        raise ValueError(f"the split-table scans take a power-of-two pts >= 2, got {pts}")


def _parity(pts: int, device: torch.device):
    """(even-lane mask, pm = +1 on even lanes and -1 on odd) of length pts."""
    even = torch.arange(pts, device=device) % 2 == 0
    return even, torch.where(even, 1.0, -1.0).to(torch.float32)


def _split_frames(blocks: torch.Tensor, pts: int) -> Cplx:
    """Forward frames of blocks (nb, C, pts) through the factored chain
    (JAX ``splitstep.fwd_ref``): the products of the block, its parity
    swap and both with odd lanes negated against ctab^T, then the pack with
    the 8 forward coefficients. Split (C, nb, bins)."""
    _, ctab_t, fc, _ = split_tables(pts, blocks.device)
    x = blocks.to(torch.float32)
    even, pm = _parity(pts, x.device)
    xs = torch.where(even, torch.roll(x, -1, -1), -torch.roll(x, 1, -1))
    fr, fi, gr, gi = (v @ ctab_t for v in (x, xs, x * pm, xs * pm))
    re = fr * fc[0] + gr * fc[1] + fi * fc[2] + gi * fc[3]
    im = fr * fc[4] + gr * fc[5] + fi * fc[6] + gi * fc[7]
    return re.transpose(0, 1), im.transpose(0, 1)


def _split_post_ola(acc_r: torch.Tensor, acc_i: torch.Tensor, tails: torch.Tensor,
                    pts: int):
    """Inverse of the (C, nb, bins) accumulators through the factored
    chain (JAX ``splitstep.inv_ref``: unpack coefficients, the products
    against ctab, the parity combines), overlap-add with the carried tails,
    / pts: (outs (nb, C, pts), final tails (C, pts))."""
    ctab, _, _, ic = split_tables(pts, acc_r.device)
    even, pm = _parity(pts, acc_r.device)

    def sw(v):
        return torch.where(even, -torch.roll(v, -1, -1), torch.roll(v, 1, -1))

    def half(a, b, d, e):
        ya, yb, yd, ye = (v @ ctab for v in (a, b, d, e))
        return (ya + yb * pm) + sw(yd + ye * pm)

    z = [acc_r * ic[2 * j] + acc_i * ic[2 * j + 1] for j in range(4)]   # A, B, D, E
    out1, out2 = half(*z), half(*(v * pm for v in z))
    prev = torch.cat([tails[:, None], out2[:, :-1]], 1)
    return ((out1 + prev) / pts).transpose(0, 1).contiguous(), out2[:, -1].contiguous()


def _launch(blocks, w0, h, b0_scale, tails, pts, dev):
    """The LTI CUDA entry on (nb, C, pts) blocks."""
    (w0r, w0i), (hr, hi) = w0, h
    nb, nch, _ = blocks.shape
    nparts = hr.shape[1]
    f32 = dict(dtype=torch.float32, device=dev)
    outs = torch.empty((nb, nch, pts), **f32)
    wfr, wfi = (torch.empty((nch, nparts, pts), **f32) for _ in range(2))
    tailf = torch.empty((nch, pts), **f32)
    timeline = torch.empty((nch, nparts + nb, 2 * pts), **f32)
    aext = torch.empty((nch, nb + 2, 2 * pts), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(*_ptrs(blocks, w0r, w0i, hr, hi, *split_tables(pts, dev), tails, outs,
                           wfr, wfi, tailf, timeline, aext),
                    nb, nch, nparts, pts, float(b0_scale), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"stream_steps_fused_split_batched_f32: CUDA error {err} at launch")
    return outs, (wfr, wfi), tailf


def _launch_tv(blocks_x, blocks_h, w0, h0, wp2, b0_scale, tails, pts, dev):
    """The TV CUDA entry on (nb, C, pts) blocks; ``wp2`` as
    ``_channel_pointers`` returns it."""
    (w0r, w0i), (h0r, h0i) = w0, h0
    nb, nch, _ = blocks_x.shape
    nparts = h0r.shape[1]
    if isinstance(wp2, tuple):
        slots, offset, stride = torch.tensor(wp2, dtype=torch.int32, device=dev), 0, 1
    else:
        slots, offset, stride = _slot_table(nparts, dev), 4 * wp2, 0
    f32 = dict(dtype=torch.float32, device=dev)
    outs = torch.empty((nb, nch, pts), **f32)
    wfr, wfi, hfr, hfi = (torch.empty((nch, nparts, pts), **f32) for _ in range(4))
    tailf = torch.empty((nch, pts), **f32)
    timeline = torch.empty((nch, nparts + nb, 2 * pts), **f32)
    htimeline = torch.empty((nch, nparts - 1 + nb, 2 * pts), **f32)
    aext = torch.empty((nch, nb + 2, 2 * pts), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _tv_kernel()(
        *_ptrs(blocks_x, blocks_h, w0r, w0i, h0r, h0i), slots.data_ptr() + offset, stride,
        *_ptrs(*split_tables(pts, dev), tails, outs, wfr, wfi, hfr, hfi, tailf, timeline,
               htimeline, aext),
        nb, nch, nparts, pts, float(b0_scale), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"stream_steps_fused_split_batched_tv_f32: CUDA error {err} "
                           f"at launch")
    return outs, (wfr, wfi), (hfr, hfi), tailf


def stream_steps_fused_split_batched(blocks: torch.Tensor, w0: Cplx, h: Cplx,
                                     b0_scale: float, tails: torch.Tensor, pts: int):
    """An entire LTI scan of C channels on the factored tables: arguments
    and results as ``streamstep.stream_steps_fused_batched``."""
    global LAUNCHES
    _check_pts(pts)
    _check_batched(blocks, *w0, *h, tails, pts)
    dev = _build.launch_device("stream_steps_fused_split_batched", (blocks, *w0, *h, tails))
    if dev.type == "cpu":
        return stream_steps_fused_split_batched_plain(blocks, w0, h, b0_scale, tails, pts)
    got = _launch(blocks, w0, h, b0_scale, tails, pts, dev)
    LAUNCHES += 1
    return got


def stream_steps_fused_split_batched_plain(blocks: torch.Tensor, w0: Cplx, h: Cplx,
                                           b0_scale: float, tails: torch.Tensor, pts: int):
    """Plain PyTorch twin of the batched LTI split scan."""
    return _lti_scan_plain(blocks, w0, h, b0_scale, tails, pts, _split_frames, _split_post_ola)


def stream_steps_fused_split(blocks: torch.Tensor, w0: Cplx, h: Cplx, b0_scale: float,
                             tail: torch.Tensor, pts: int):
    """An entire LTI scan of one channel on the factored tables: arguments
    and results as ``streamstep.stream_steps_fused``."""
    _check_pts(pts)
    _check(blocks, *w0, *h, tail, pts)
    outs, (wfr, wfi), tailf = stream_steps_fused_split_batched(
        blocks[:, None], _one(w0), _one(h), b0_scale, tail[None], pts)
    return outs[:, 0], (wfr[0], wfi[0]), tailf[0]


def stream_steps_fused_split_plain(blocks: torch.Tensor, w0: Cplx, h: Cplx, b0_scale: float,
                                   tail: torch.Tensor, pts: int):
    """Plain PyTorch twin of the LTI split scan: the batched twin at one
    channel."""
    outs, (wfr, wfi), tailf = stream_steps_fused_split_batched_plain(
        blocks[:, None], _one(w0), _one(h), b0_scale, tail[None], pts)
    return outs[:, 0], (wfr[0], wfi[0]), tailf[0]


def _check_tv_blocks(blocks_x, blocks_h):
    if tuple(blocks_h.shape) != tuple(blocks_x.shape):
        raise ValueError(f"blocks_h must have the shape of blocks_x "
                         f"{tuple(blocks_x.shape)}, got {tuple(blocks_h.shape)}")


def stream_steps_fused_split_batched_tv(blocks_x: torch.Tensor, blocks_h: torch.Tensor,
                                        w0: Cplx, h0: Cplx, wp2: Pointers, b0_scale: float,
                                        tails: torch.Tensor, pts: int):
    """An entire TV scan of C channels on the factored tables: arguments
    and results as ``streamstep.stream_steps_fused_batched_tv``."""
    global TV_LAUNCHES
    _check_pts(pts)
    _check_batched(blocks_x, *w0, *h0, tails, pts)
    _check_tv_blocks(blocks_x, blocks_h)
    wp2 = _channel_pointers(wp2, blocks_x.shape[1], h0[0].shape[1])
    dev = _build.launch_device("stream_steps_fused_split_batched_tv",
                               (blocks_x, blocks_h, *w0, *h0, tails))
    if dev.type == "cpu":
        return stream_steps_fused_split_batched_tv_plain(blocks_x, blocks_h, w0, h0, wp2,
                                                         b0_scale, tails, pts)
    got = _launch_tv(blocks_x, blocks_h, w0, h0, wp2, b0_scale, tails, pts, dev)
    TV_LAUNCHES += 1
    return got


def stream_steps_fused_split_batched_tv_plain(blocks_x: torch.Tensor, blocks_h: torch.Tensor,
                                              w0: Cplx, h0: Cplx, wp2: Pointers,
                                              b0_scale: float, tails: torch.Tensor, pts: int):
    """Plain PyTorch twin of the batched TV split scan."""
    return _tv_scan_plain(blocks_x, blocks_h, w0, h0, wp2, b0_scale, tails, pts,
                         _split_frames, _split_post_ola)


def stream_steps_fused_split_tv(blocks_x: torch.Tensor, blocks_h: torch.Tensor, w0: Cplx,
                                h0: Cplx, wp2: int, b0_scale: float, tail: torch.Tensor,
                                pts: int):
    """An entire TV scan of one channel on the factored tables: arguments
    and results as ``streamstep.stream_steps_fused_tv`` (the JAX wrapper
    takes the two operands interleaved in one array; here they are two)."""
    _check_pts(pts)
    _check(blocks_x, *w0, *h0, tail, pts)
    _check_tv_blocks(blocks_x, blocks_h)
    outs, (wfr, wfi), (hfr, hfi), tailf = stream_steps_fused_split_batched_tv(
        blocks_x[:, None], blocks_h[:, None], _one(w0), _one(h0), int(wp2), b0_scale,
        tail[None], pts)
    return outs[:, 0], (wfr[0], wfi[0]), (hfr[0], hfi[0]), tailf[0]


def stream_steps_fused_split_tv_plain(blocks_x: torch.Tensor, blocks_h: torch.Tensor,
                                      w0: Cplx, h0: Cplx, wp2: int, b0_scale: float,
                                      tail: torch.Tensor, pts: int):
    """Plain PyTorch twin of the TV split scan: the batched twin at one
    channel."""
    outs, (wfr, wfi), (hfr, hfi), tailf = stream_steps_fused_split_batched_tv_plain(
        blocks_x[:, None], blocks_h[:, None], _one(w0), _one(h0), wp2, b0_scale, tail[None],
        pts)
    return outs[:, 0], (wfr[0], wfi[0]), (hfr[0], hfi[0]), tailf[0]
