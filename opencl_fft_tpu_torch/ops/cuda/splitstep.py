"""Whole-scan streaming convolution with in-kernel FFTs, LTI and
time-varying, for one channel or many: the CUDA kernels of
``csrc/splitstep.cu`` and their plain PyTorch twins.

Counterparts of ``opencl_fft_tpu/ops/pallas/splitstep.py``
``stream_steps_fused_split`` and ``stream_steps_fused_split_tv``: the scans
of ``ops/cuda/streamstep.py`` (same arguments, same results within float32
rounding) without its dense (pts, 2 pts) and (2 pts, 2 pts) transform
tables, which grow to 400 MB at pts 4096. Each block's forward chain is an
m-point complex FFT (m = pts) of the half-size sequence z_j = x_2j +
i x_2j+1, then the pack with the forward coefficient stack; each output
row's inverse chain is the unpack (inverse stack) of acc[t] + (-1)^k
acc[t-1], an unnormalized m-point inverse FFT and a deinterleave of its
first m/2 values, which is the overlap-added block (``tables._coef_stacks_np``
holds both stacks; the JAX package factors the same chains through a
(pts, pts) table, ``fwd_ref`` / ``inv_ref``). The engine (``ops/pconv.py``)
runs them above ``_FWD_MM_MAX_PTS``; the wrappers take any power-of-two
pts >= 2, and the kernels transform up to 2^14 points inside a CTA and
larger sizes up to ``MAX_PTS`` by the four-step of ``csrc/fft_tile.cuh``.

The single-channel wrappers are the C = 1 case of the batched ones; the
batched scans take blocks (nblocks, C, pts) and, in the TV scan, one ring
pointer shared by every channel or one each. Each wrapper runs its CUDA
kernel for CUDA tensors and its twin for CPU tensors; anything else raises.
The twins are the kernels' chains in plain PyTorch (``torch.fft``) around
the dense scan twins' MAC. ``LAUNCHES`` counts launches of the LTI kernel,
``TV_LAUNCHES`` of the TV kernel, through any of the wrappers.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ...utils.numerics import is_pow2
from ..cplx import Cplx
from . import _build
from .streamstep import (Pointers, _channel_pointers, _check, _check_batched, _one, _ptrs,
                         _slot_table, _lti_scan_plain, _tv_scan_plain)
from .tables import coef_tables
from .vmemfft import (LEAF_PASS_MAX, SINGLE_PASS_MAX, four_step_log_a,
                      four_step_tables_np, pass_twiddle_np, two_pass_split)

LAUNCHES = 0
TV_LAUNCHES = 0

MAX_PTS = LEAF_PASS_MAX ** 2   # the four-step's factors are at most 2^13 each

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("splitstep").stream_steps_fused_split_batched_f32
    fn.argtypes = [_P] * 16 + [_I] * 6 + [ctypes.c_float, _I, _P]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _tv_kernel():
    fn = _build.load("splitstep").stream_steps_fused_split_batched_tv_f32
    fn.argtypes = [_P] * 7 + [_I] + [_P] * 14 + [_I] * 6 + [ctypes.c_float, _I, _P]
    fn.restype = ctypes.c_int
    return fn


def _check_pts(pts: int):
    if not is_pow2(pts) or pts < 2:
        raise ValueError(f"the split scans take a power-of-two pts >= 2, got {pts}")


def _nflip(v: torch.Tensor) -> torch.Tensor:
    """Index negation along the last axis: v_k -> v_{(m-k) mod m}."""
    return torch.roll(torch.flip(v, (-1,)), 1, -1)


def _fft_frames(blocks: torch.Tensor, pts: int) -> Cplx:
    """Forward frames of blocks (nb, C, pts), the kernel's chain: the FFT of
    z_j = x_2j + i x_2j+1 zero-padded to pts points, then the pack with the
    forward coefficient stack. Split (C, nb, bins)."""
    fc, _ = coef_tables(pts, blocks.device)
    x = blocks.to(torch.float32)
    z = torch.fft.fft(torch.complex(x[..., 0::2], x[..., 1::2]), n=pts)
    zr, zi = z.real, z.imag
    fr, fi = _nflip(zr), _nflip(zi)
    re = zr * fc[0] + fr * fc[1] + zi * fc[2] + fi * fc[3]
    im = zr * fc[4] + fr * fc[5] + zi * fc[6] + fi * fc[7]
    return re.transpose(0, 1), im.transpose(0, 1)


def _fft_post_ola(acc_r: torch.Tensor, acc_i: torch.Tensor, tails: torch.Tensor, pts: int):
    """The (C, nb, bins) accumulators to output blocks, the kernel's chain:
    row t (t = 0..nb) folds acc[t] + (-1)^k acc[t-1] (zero rows before and
    after), unpacks it with the inverse coefficient stack (the sign commutes
    with the unpack), inverse-transforms it unnormalized and deinterleaves
    its first pts/2 values: out1[t] + out2[t-1]; the carried tails are added
    at t = 0 and the rows divided by pts, row nb is the final tails:
    (outs (nb, C, pts), final tails (C, pts))."""
    _, ic = coef_tables(pts, acc_r.device)
    pm = torch.where(torch.arange(pts, device=acc_r.device) % 2 == 0, 1.0, -1.0)
    ar, ai = (torch.nn.functional.pad(a, (0, 0, 1, 1)) for a in (acc_r, acc_i))
    wr, wi = ar[:, 1:] + pm * ar[:, :-1], ai[:, 1:] + pm * ai[:, :-1]
    a, bv, d, e = (wr * ic[2 * j] + wi * ic[2 * j + 1] for j in range(4))
    y = torch.fft.ifft(torch.complex(a + _nflip(bv), d + _nflip(e)), norm="forward")
    y = y[..., :pts // 2]
    out = torch.stack([y.real, y.imag], -1).reshape(*y.shape[:-1], pts)   # (C, nb+1, pts)
    outs = out[:, :-1].clone()
    outs[:, 0] += tails
    return (outs / pts).transpose(0, 1).contiguous(), out[:, -1].contiguous()


class _Plan(NamedTuple):
    tables: tuple           # the device tables (kept alive with the plan)
    tabs: ctypes.Array      # their data pointers, as the C entries take them
    log_n1: int
    log_a: int


@functools.lru_cache(maxsize=None)
def _plan(pts: int, device: torch.device) -> _Plan:
    """The transforms' device tables for both signs (-1, then +1): the pass
    tables of n1 and n2 and the four-step tables A, B, S above
    ``SINGLE_PASS_MAX``; up to it the pass table of pts in the second place."""
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    tables, log_n1, log_a = [], 0, 0
    for sign in (-1, 1):
        if pts <= SINGLE_PASS_MAX:
            tables += [None, dev(pass_twiddle_np(pts, sign)), None, None, None]
        else:
            n1, n2 = two_pass_split(pts)
            log_n1, log_a = n1.bit_length() - 1, four_step_log_a(n2)
            tables += [dev(pass_twiddle_np(n1, sign)), dev(pass_twiddle_np(n2, sign)),
                       *map(dev, four_step_tables_np(n1, n2, sign))]
    tabs = (ctypes.c_void_p * 10)(*(t.data_ptr() if t is not None else None for t in tables))
    return _Plan(tuple(tables), tabs, log_n1, log_a)


def _kernel_args(pts, nb, nch, dev):
    """(plan, scratch) of one launch: the scratch planes of the four-step
    (4 C (nb+1) pts floats; none up to ``SINGLE_PASS_MAX``)."""
    if pts > MAX_PTS:
        raise ValueError(f"the split-scan kernels take pts <= {MAX_PTS}, got {pts}")
    plan = _plan(pts, dev)
    scratch = None if plan.log_n1 == 0 else torch.empty(
        4 * nch * (nb + 1) * pts, dtype=torch.float32, device=dev)
    return plan, scratch


def _aligned8(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data is not 8-byte aligned (the kernels
    read blocks as float2 pairs)."""
    return t if t.data_ptr() % 8 == 0 else t.clone()


def _launch(blocks, w0, h, b0_scale, tails, pts, dev):
    """The LTI CUDA entry on (nb, C, pts) blocks."""
    (w0r, w0i), (hr, hi) = w0, h
    nb, nch, _ = blocks.shape
    nparts = hr.shape[1]
    plan, scratch = _kernel_args(pts, nb, nch, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    outs = torch.empty((nb, nch, pts), **f32)
    wfr, wfi = (torch.empty((nch, nparts, pts), **f32) for _ in range(2))
    tailf = torch.empty((nch, pts), **f32)
    timeline = torch.empty((nch, nparts + nb, 2 * pts), **f32)
    aext = torch.empty((nch, nb + 2, 2 * pts), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(*_ptrs(_aligned8(blocks), w0r, w0i, hr, hi), ctypes.addressof(plan.tabs),
                    *_ptrs(*coef_tables(pts, dev), tails, outs, wfr, wfi, tailf, timeline, aext),
                    None if scratch is None else scratch.data_ptr(),
                    nb, nch, nparts, pts, plan.log_n1, plan.log_a, float(b0_scale), dev.index,
                    stream)
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
    plan, scratch = _kernel_args(pts, nb, nch, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    outs = torch.empty((nb, nch, pts), **f32)
    wfr, wfi, hfr, hfi = (torch.empty((nch, nparts, pts), **f32) for _ in range(4))
    tailf = torch.empty((nch, pts), **f32)
    timeline = torch.empty((nch, nparts + nb, 2 * pts), **f32)
    htimeline = torch.empty((nch, nparts - 1 + nb, 2 * pts), **f32)
    aext = torch.empty((nch, nb + 2, 2 * pts), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _tv_kernel()(
        *_ptrs(_aligned8(blocks_x), _aligned8(blocks_h), w0r, w0i, h0r, h0i),
        slots.data_ptr() + offset, stride, ctypes.addressof(plan.tabs),
        *_ptrs(*coef_tables(pts, dev), tails, outs, wfr, wfi, hfr, hfi, tailf, timeline,
               htimeline, aext),
        None if scratch is None else scratch.data_ptr(),
        nb, nch, nparts, pts, plan.log_n1, plan.log_a, float(b0_scale), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"stream_steps_fused_split_batched_tv_f32: CUDA error {err} "
                           f"at launch")
    return outs, (wfr, wfi), (hfr, hfi), tailf


def stream_steps_fused_split_batched(blocks: torch.Tensor, w0: Cplx, h: Cplx,
                                     b0_scale: float, tails: torch.Tensor, pts: int):
    """An entire LTI scan of C channels with in-kernel FFTs: arguments
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
    return _lti_scan_plain(blocks, w0, h, b0_scale, tails, pts, _fft_frames, _fft_post_ola)


def stream_steps_fused_split(blocks: torch.Tensor, w0: Cplx, h: Cplx, b0_scale: float,
                             tail: torch.Tensor, pts: int):
    """An entire LTI scan of one channel with in-kernel FFTs: arguments
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
    """An entire TV scan of C channels with in-kernel FFTs: arguments
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
                         _fft_frames, _fft_post_ola)


def stream_steps_fused_split_tv(blocks_x: torch.Tensor, blocks_h: torch.Tensor, w0: Cplx,
                                h0: Cplx, wp2: int, b0_scale: float, tail: torch.Tensor,
                                pts: int):
    """An entire TV scan of one channel with in-kernel FFTs: arguments
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
