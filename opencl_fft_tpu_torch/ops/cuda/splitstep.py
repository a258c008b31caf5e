"""Whole-scan streaming convolution at any partition size, LTI and
time-varying, for one channel or many: the split-scan wrappers of the CUDA
kernels of ``csrc/streamstep.cu`` and their plain PyTorch twins.

Counterparts of ``opencl_fft_tpu/ops/pallas/splitstep.py``
``stream_steps_fused_split`` and ``stream_steps_fused_split_tv``: the scans
of ``ops/cuda/streamstep.py`` (same arguments, same results within float32
rounding), which the JAX package factors through a (pts, pts) table
(``fwd_ref`` / ``inv_ref``) where its dense (pts, 2 pts) and (2 pts, 2 pts)
tables grow large (400 MB at pts 4096). Here both families launch the same
CUDA entries, whose in-kernel FFTs make no tables of that size: the engine
(``ops/pconv.py``) runs these wrappers above ``_FWD_MM_MAX_PTS``, as the
JAX package runs its split kernels there, and ``streamstep.py``'s up to
it. The wrappers take any power-of-two pts >= 2; the kernels transform up
to 2^14 points inside a CTA and larger sizes up to ``streamstep.MAX_PTS``
by the four-step of ``csrc/fft_tile.cuh``.

The single-channel wrappers are the C = 1 case of the batched ones; the
batched scans take blocks (nblocks, C, pts) and, in the TV scan, one ring
pointer shared by every channel or one each. Each wrapper runs its CUDA
kernel for CUDA tensors and its twin (``streamstep.py``'s) for CPU tensors;
anything else raises. ``LAUNCHES`` counts launches of the LTI kernel,
``TV_LAUNCHES`` of the TV kernel, through any of these wrappers.
"""

from __future__ import annotations

import torch

from ..cplx import Cplx
from . import _build
from .streamstep import (Pointers, _channel_pointers, _check, _check_batched, _check_tv_blocks,
                         _launch, _launch_tv, _one, stream_steps_fused_batched_plain,
                         stream_steps_fused_batched_tv_plain)

LAUNCHES = 0
TV_LAUNCHES = 0


def stream_steps_fused_split_batched(blocks: torch.Tensor, w0: Cplx, h: Cplx,
                                     b0_scale: float, tails: torch.Tensor, pts: int):
    """An entire LTI scan of C channels with in-kernel FFTs: arguments
    and results as ``streamstep.stream_steps_fused_batched``."""
    global LAUNCHES
    _check_batched(blocks, *w0, *h, tails, pts)
    dev = _build.launch_device("stream_steps_fused_split_batched", (blocks, *w0, *h, tails))
    if dev.type == "cpu":
        return stream_steps_fused_split_batched_plain(blocks, w0, h, b0_scale, tails, pts)
    got = _launch("stream_steps_fused_split_batched", blocks, w0, h, b0_scale, tails, pts, dev)
    LAUNCHES += 1
    return got


# the twins of the batched split scans: the scan twins, whose chains the
# kernels share
stream_steps_fused_split_batched_plain = stream_steps_fused_batched_plain
stream_steps_fused_split_batched_tv_plain = stream_steps_fused_batched_tv_plain


def stream_steps_fused_split(blocks: torch.Tensor, w0: Cplx, h: Cplx, b0_scale: float,
                             tail: torch.Tensor, pts: int):
    """An entire LTI scan of one channel with in-kernel FFTs: arguments
    and results as ``streamstep.stream_steps_fused``."""
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


def stream_steps_fused_split_batched_tv(blocks_x: torch.Tensor, blocks_h: torch.Tensor,
                                        w0: Cplx, h0: Cplx, wp2: Pointers, b0_scale: float,
                                        tails: torch.Tensor, pts: int):
    """An entire TV scan of C channels with in-kernel FFTs: arguments
    and results as ``streamstep.stream_steps_fused_batched_tv``."""
    global TV_LAUNCHES
    _check_batched(blocks_x, *w0, *h0, tails, pts)
    _check_tv_blocks(blocks_x, blocks_h)
    wp2 = _channel_pointers(wp2, blocks_x.shape[1], h0[0].shape[1])
    dev = _build.launch_device("stream_steps_fused_split_batched_tv",
                               (blocks_x, blocks_h, *w0, *h0, tails))
    if dev.type == "cpu":
        return stream_steps_fused_split_batched_tv_plain(blocks_x, blocks_h, w0, h0, wp2,
                                                         b0_scale, tails, pts)
    got = _launch_tv("stream_steps_fused_split_batched_tv", blocks_x, blocks_h, w0, h0, wp2,
                     b0_scale, tails, pts, dev)
    TV_LAUNCHES += 1
    return got


def stream_steps_fused_split_tv(blocks_x: torch.Tensor, blocks_h: torch.Tensor, w0: Cplx,
                                h0: Cplx, wp2: int, b0_scale: float, tail: torch.Tensor,
                                pts: int):
    """An entire TV scan of one channel with in-kernel FFTs: arguments
    and results as ``streamstep.stream_steps_fused_tv`` (the JAX wrapper
    takes the two operands interleaved in one array; here they are two)."""
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
