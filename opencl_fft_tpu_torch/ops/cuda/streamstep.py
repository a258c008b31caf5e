"""Whole-scan streaming convolution, LTI and time-varying: the CUDA
kernels of ``csrc/streamstep.cu`` and their plain PyTorch twins.

Counterparts of ``opencl_fft_tpu/ops/pallas/streamstep.py``
``stream_steps_fused`` and ``stream_steps_fused_tv``, with the same results:
every block of the scan goes through forward rFFT (one matmul against the
``wfwd`` table), a one-frame window slide, the frequency-delay-line complex
MAC (bin 0 componentwise, times ``b0_scale``), one matmul against ``wpost``
and the overlap-add / pts. In the TV scan block t's coefficient frame is
first written into the IR ring at slot (wp2 - t) mod nparts.

The scans are computed block-parallel: all input blocks are known up front,
so the forward frames of the whole scan form one timeline behind the
initial window, and block t's window is timeline rows [t+1, t+1+nparts).
The TV scan's coefficient frames form a second timeline (see
``stream_steps_fused_tv_plain``).

Each wrapper runs its CUDA kernel for CUDA tensors and its twin for CPU
tensors; anything else raises. ``LAUNCHES`` counts launches of the LTI
kernel, ``TV_LAUNCHES`` of the TV kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..cplx import Cplx
from . import _build
from .tables import fwd_table, post_ola_table, post_table

LAUNCHES = 0
TV_LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("streamstep").stream_steps_fused_f32
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 14 + [i, i, i, ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _tv_kernel():
    fn = _build.load("streamstep").stream_steps_fused_tv_f32
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 18 + [i, i, i, i, ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


def _check(blocks, w0r, w0i, hr, hi, tail, pts):
    if blocks.dim() != 2 or blocks.shape[1] != pts or blocks.shape[0] < 1:
        raise ValueError(f"blocks must be (nblocks >= 1, {pts}), got {tuple(blocks.shape)}")
    if hr.dim() != 2 or hr.shape[1] != pts:
        raise ValueError(f"h planes must be (nparts, {pts}), got {tuple(hr.shape)}")
    for name, t, shape in (("w0 re", w0r, hr.shape), ("w0 im", w0i, hr.shape),
                           ("h im", hi, hr.shape), ("tail", tail, (pts,))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")


def stream_steps_fused(blocks: torch.Tensor, w0: Cplx, h: Cplx,
                       b0_scale: float, tail: torch.Tensor, pts: int):
    """Run an entire LTI streaming scan in one call.

    blocks: (nblocks, pts); w0: split (nparts, bins) initial window (row q
    = frame wp0+q, i.e. doubled-ring rows [wp0, wp0+nparts)); h: split
    (nparts, bins) IR spectra, stored reversed; tail: (bins,), bins == pts.
    Returns (outs (nblocks, pts), (wfr, wfi), tail_fin (bins,)); final
    window row q holds frame wp0 + nblocks + q.
    """
    global LAUNCHES
    w0r, w0i = w0
    hr, hi = h
    _check(blocks, w0r, w0i, hr, hi, tail, pts)
    dev = _build.launch_device("stream_steps_fused", (blocks, w0r, w0i, hr, hi, tail))
    if dev.type == "cpu":
        return stream_steps_fused_plain(blocks, w0, h, b0_scale, tail, pts)
    nparts, bins = hr.shape
    nb = blocks.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    outs = torch.empty((nb, pts), **f32)
    wfr = torch.empty((nparts, bins), **f32)
    wfi = torch.empty((nparts, bins), **f32)
    tailf = torch.empty((bins,), **f32)
    timeline = torch.empty((nparts + nb, 2 * bins), **f32)
    aext = torch.empty((nb + 2, 2 * bins), **f32)
    wfwd = fwd_table(pts, dev)
    w2 = post_ola_table(bins, dev)
    ptrs = [t.data_ptr() for t in (blocks, w0r, w0i, hr, hi, wfwd, w2, tail,
                                   outs, wfr, wfi, tailf, timeline, aext)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(*ptrs, nb, nparts, pts, float(b0_scale), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"stream_steps_fused: CUDA error {err} at launch")
    LAUNCHES += 1
    return outs, (wfr, wfi), tailf


def stream_steps_fused_plain(blocks: torch.Tensor, w0: Cplx, h: Cplx,
                             b0_scale: float, tail: torch.Tensor, pts: int):
    """Plain PyTorch twin of the CUDA kernel: the same three steps, with
    the MAC summed over partitions in the kernel's order (q ascending)."""
    w0r, w0i = w0
    hr, hi = h
    nparts, bins = hr.shape
    nb = blocks.shape[0]
    dev = blocks.device
    f = blocks.to(torch.float32) @ fwd_table(pts, dev)         # (nb, 2b)
    tr = torch.cat([w0r, f[:, :bins]])                         # (nparts+nb, b)
    ti = torch.cat([w0i, f[:, bins:]])
    acc_r = torch.zeros((nb, bins), dtype=torch.float32, device=dev)
    acc_i = torch.zeros_like(acc_r)
    for q in range(nparts):
        xr, xi = tr[1 + q:1 + q + nb], ti[1 + q:1 + q + nb]
        acc_r += xr * hr[q] - xi * hi[q]
        acc_i += xr * hi[q] + xi * hr[q]
    acc_r[:, 0] = b0_scale * (tr[1:, 0].unfold(0, nparts, 1) * hr[:, 0]).sum(-1)
    acc_i[:, 0] = b0_scale * (ti[1:, 0].unfold(0, nparts, 1) * hi[:, 0]).sum(-1)
    outs, tailf = _post_ola_plain(acc_r, acc_i, tail, pts)
    return outs, (tr[nb:nb + nparts], ti[nb:nb + nparts]), tailf


def _post_ola_plain(acc_r, acc_i, tail, pts):
    """[acc_r | acc_i] @ wpost, overlap-add with the carried tail, / pts:
    returns (outs (nb, pts), final tail (pts,))."""
    y = torch.cat([acc_r, acc_i], dim=1) @ post_table(pts, acc_r.device)  # (nb, 2b)
    prev = torch.cat([tail[None], y[:-1, pts:]])
    return (y[:, :pts] + prev) / pts, y[-1, pts:]


def stream_steps_fused_tv(blocks_x: torch.Tensor, blocks_h: torch.Tensor,
                          w0: Cplx, h0: Cplx, wp2: int, b0_scale: float,
                          tail: torch.Tensor, pts: int):
    """Run an entire time-varying streaming scan in one call.

    blocks_x, blocks_h: (nblocks, pts) input and coefficient operands;
    w0 as in ``stream_steps_fused``; h0: split (nparts, bins) coefficient
    ring (MAC layout), written at the decrementing slot wp2; tail: (bins,).
    Returns (outs (nblocks, pts), (wfr, wfi), (hfr, hfi), tail_fin): the
    final window, the final coefficient ring (its pointer is
    (wp2 - nblocks) mod nparts) and the final tail.
    """
    global TV_LAUNCHES
    w0r, w0i = w0
    h0r, h0i = h0
    _check(blocks_x, w0r, w0i, h0r, h0i, tail, pts)
    if tuple(blocks_h.shape) != tuple(blocks_x.shape):
        raise ValueError(f"blocks_h must have the shape of blocks_x "
                         f"{tuple(blocks_x.shape)}, got {tuple(blocks_h.shape)}")
    dev = _build.launch_device("stream_steps_fused_tv",
                               (blocks_x, blocks_h, w0r, w0i, h0r, h0i, tail))
    if dev.type == "cpu":
        return stream_steps_fused_tv_plain(blocks_x, blocks_h, w0, h0, wp2, b0_scale,
                                           tail, pts)
    nparts, bins = h0r.shape
    nb = blocks_x.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    outs = torch.empty((nb, pts), **f32)
    wfr, wfi, hfr, hfi = (torch.empty((nparts, bins), **f32) for _ in range(4))
    tailf = torch.empty((bins,), **f32)
    timeline = torch.empty((nparts + nb, 2 * bins), **f32)
    htimeline = torch.empty((nparts - 1 + nb, 2 * bins), **f32)
    aext = torch.empty((nb + 2, 2 * bins), **f32)
    ptrs = [t.data_ptr() for t in (
        blocks_x, blocks_h, w0r, w0i, h0r, h0i, fwd_table(pts, dev),
        post_ola_table(bins, dev), tail, outs, wfr, wfi, hfr, hfi, tailf, timeline,
        htimeline, aext)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _tv_kernel()(*ptrs, nb, nparts, pts, int(wp2) % nparts, float(b0_scale),
                       dev.index, stream)
    if err != 0:
        raise RuntimeError(f"stream_steps_fused_tv: CUDA error {err} at launch")
    TV_LAUNCHES += 1
    return outs, (wfr, wfi), (hfr, hfi), tailf


def _tv_rows(t: torch.Tensor, q, wp2: int, nparts: int) -> torch.Tensor:
    """Row of the coefficient timeline that ring slot q holds at block t:
    that of the last block s <= t with s = wp2 - q (mod nparts), at row
    s + nparts - 1 (rows [0, nparts-1) are pseudo-times -(nparts-1)..-1)."""
    return t - (t - wp2 + q) % nparts + nparts - 1


def stream_steps_fused_tv_plain(blocks_x: torch.Tensor, blocks_h: torch.Tensor,
                                w0: Cplx, h0: Cplx, wp2: int, b0_scale: float,
                                tail: torch.Tensor, pts: int):
    """Plain PyTorch twin of the TV kernel, from the same timelines.

    x timeline: rows [0, nparts) = w0, then block t's input frame at row
    nparts + t. h timeline: the initial ring in time order (row j = the
    frame of pseudo-time s = j - (nparts-1), ring slot (wp2 - s) mod nparts),
    then block t's coefficient frame at row nparts - 1 + t. The MAC pairs
    window row q of block t with h timeline row ``_tv_rows(t, q)``, summed
    over q ascending as the kernel does; the final ring is the same gather
    at t = nblocks - 1.
    """
    w0r, w0i = w0
    h0r, h0i = h0
    nparts, bins = h0r.shape
    nb = blocks_x.shape[0]
    dev = blocks_x.device
    wp2 = int(wp2) % nparts
    tab = fwd_table(pts, dev)
    fx = blocks_x.to(torch.float32) @ tab                     # (nb, 2b)
    fh = blocks_h.to(torch.float32) @ tab
    tr = torch.cat([w0r, fx[:, :bins]])                       # (nparts+nb, b)
    ti = torch.cat([w0i, fx[:, bins:]])
    slots = (wp2 - torch.arange(-(nparts - 1), 0, device=dev)) % nparts
    htr = torch.cat([h0r[slots], fh[:, :bins]])               # (nparts-1+nb, b)
    hti = torch.cat([h0i[slots], fh[:, bins:]])
    t = torch.arange(nb, device=dev)
    acc_r = torch.zeros((nb, bins), dtype=torch.float32, device=dev)
    acc_i = torch.zeros_like(acc_r)
    dc_r = torch.zeros((nb,), dtype=torch.float32, device=dev)
    dc_i = torch.zeros_like(dc_r)
    for q in range(nparts):
        xr, xi = tr[1 + q:1 + q + nb], ti[1 + q:1 + q + nb]
        rows = _tv_rows(t, q, wp2, nparts)
        hr, hi = htr[rows], hti[rows]
        acc_r += xr * hr - xi * hi
        acc_i += xr * hi + xi * hr
        dc_r += xr[:, 0] * hr[:, 0]
        dc_i += xi[:, 0] * hi[:, 0]
    acc_r[:, 0] = b0_scale * dc_r
    acc_i[:, 0] = b0_scale * dc_i
    outs, tailf = _post_ola_plain(acc_r, acc_i, tail, pts)
    rows = _tv_rows(nb - 1, torch.arange(nparts, device=dev), wp2, nparts)
    return (outs, (tr[nb:nb + nparts], ti[nb:nb + nparts]), (htr[rows], hti[rows]),
            tailf)
