"""Whole-scan streaming convolution, LTI and time-varying, for one channel
or many: the CUDA kernels of ``csrc/streamstep.cu`` and their plain
PyTorch twins.

Counterparts of ``opencl_fft_tpu/ops/pallas/streamstep.py``
``stream_steps_fused``, ``stream_steps_fused_tv``,
``stream_steps_fused_batched`` and ``stream_steps_fused_batched_tv``, with
the same results: every block of the scan goes through forward rFFT (one
matmul against the ``wfwd`` table), a one-frame window slide, the
frequency-delay-line complex MAC (bin 0 componentwise, times ``b0_scale``),
one matmul against ``wpost`` and the overlap-add / pts. In the TV scan
block t's coefficient frame is first written into the IR ring at slot
(wp2 - t) mod nparts.

The batched scans take blocks (nblocks, C, pts): block t of channel c is
row t*C + c of the (nblocks*C, pts) matrix, the row order of the JAX
batched kernels. Every channel has its own window, IR ring and tail, and
in the TV scan its own coefficient-ring pointer (one int shared by every
channel, or a length-C sequence). A single-channel scan is the C = 1 case
of the same CUDA entry and of the same twin.

The scans are computed block-parallel: all input blocks are known up front,
so the forward frames of a channel's scan form one timeline behind its
initial window, and block t's window is timeline rows [t+1, t+1+nparts).
The TV scan's coefficient frames form a second timeline (see
``stream_steps_fused_batched_tv_plain``).

Each wrapper runs its CUDA kernel for CUDA tensors and its twin for CPU
tensors; anything else raises. ``LAUNCHES`` counts launches of the LTI
scan, ``TV_LAUNCHES`` of the TV scan, ``BATCHED_LAUNCHES`` and
``BATCHED_TV_LAUNCHES`` of their batched forms.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Union

import torch

from ..cplx import Cplx
from . import _build
from .tables import fwd_table, post_ola_table, post_table

LAUNCHES = 0
TV_LAUNCHES = 0
BATCHED_LAUNCHES = 0
BATCHED_TV_LAUNCHES = 0

Pointers = Union[int, Sequence[int]]


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("streamstep").stream_steps_fused_batched_f32
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 14 + [i, i, i, i, ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _tv_kernel():
    fn = _build.load("streamstep").stream_steps_fused_batched_tv_f32
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 7 + [i] + [p] * 12 + [i, i, i, i, ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _slot_table(nparts: int, device: torch.device) -> torch.Tensor:
    """int32 [0, nparts) on ``device``: a shared ring pointer p is passed to
    the TV kernel as the address of entry p with channel stride 0."""
    return torch.arange(nparts, dtype=torch.int32, device=device)


def _check(blocks, w0r, w0i, hr, hi, tail, pts):
    if blocks.dim() != 2 or blocks.shape[1] != pts or blocks.shape[0] < 1:
        raise ValueError(f"blocks must be (nblocks >= 1, {pts}), got {tuple(blocks.shape)}")
    if hr.dim() != 2 or hr.shape[1] != pts:
        raise ValueError(f"h planes must be (nparts, {pts}), got {tuple(hr.shape)}")
    for name, t, shape in (("w0 re", w0r, hr.shape), ("w0 im", w0i, hr.shape),
                           ("h im", hi, hr.shape), ("tail", tail, (pts,))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")


def _check_batched(blocks, w0r, w0i, hr, hi, tails, pts):
    if blocks.dim() != 3 or blocks.shape[0] < 1 or blocks.shape[1] < 1 \
            or blocks.shape[2] != pts:
        raise ValueError(f"blocks must be (nblocks >= 1, channels >= 1, {pts}), "
                         f"got {tuple(blocks.shape)}")
    nch = blocks.shape[1]
    if hr.dim() != 3 or hr.shape[0] != nch or hr.shape[2] != pts:
        raise ValueError(f"h planes must be ({nch}, nparts, {pts}), got {tuple(hr.shape)}")
    for name, t, shape in (("w0 re", w0r, hr.shape), ("w0 im", w0i, hr.shape),
                           ("h im", hi, hr.shape), ("tails", tails, (nch, pts))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _channel_pointers(wp2: Pointers, nch: int, nparts: int):
    """``wp2`` mod nparts: an int when shared by every channel, else a
    tuple of one int per channel."""
    if isinstance(wp2, (tuple, list)):
        if len(wp2) != nch:
            raise ValueError(f"wp2 needs one pointer per channel ({nch}), got {len(wp2)}")
        return tuple(int(p) % nparts for p in wp2)
    return int(wp2) % nparts


def _launch(name, blocks, w0, h, b0_scale, tails, pts, dev):
    """The LTI CUDA entry on (nb, C, pts) blocks."""
    (w0r, w0i), (hr, hi) = w0, h
    nb, nch, _ = blocks.shape
    nparts, bins = hr.shape[1:]
    f32 = dict(dtype=torch.float32, device=dev)
    outs = torch.empty((nb, nch, pts), **f32)
    wfr = torch.empty((nch, nparts, bins), **f32)
    wfi = torch.empty((nch, nparts, bins), **f32)
    tailf = torch.empty((nch, bins), **f32)
    timeline = torch.empty((nch, nparts + nb, 2 * bins), **f32)
    aext = torch.empty((nch, nb + 2, 2 * bins), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(*_ptrs(blocks, w0r, w0i, hr, hi, fwd_table(pts, dev),
                           post_ola_table(bins, dev), tails, outs, wfr, wfi, tailf,
                           timeline, aext),
                    nb, nch, nparts, pts, float(b0_scale), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    return outs, (wfr, wfi), tailf


def _launch_tv(name, blocks_x, blocks_h, w0, h0, wp2, b0_scale, tails, pts, dev):
    """The TV CUDA entry on (nb, C, pts) blocks; ``wp2`` as
    ``_channel_pointers`` returns it."""
    (w0r, w0i), (h0r, h0i) = w0, h0
    nb, nch, _ = blocks_x.shape
    nparts, bins = h0r.shape[1:]
    if isinstance(wp2, tuple):
        slots, offset, stride = torch.tensor(wp2, dtype=torch.int32, device=dev), 0, 1
    else:
        slots, offset, stride = _slot_table(nparts, dev), 4 * wp2, 0
    f32 = dict(dtype=torch.float32, device=dev)
    outs = torch.empty((nb, nch, pts), **f32)
    wfr, wfi, hfr, hfi = (torch.empty((nch, nparts, bins), **f32) for _ in range(4))
    tailf = torch.empty((nch, bins), **f32)
    timeline = torch.empty((nch, nparts + nb, 2 * bins), **f32)
    htimeline = torch.empty((nch, nparts - 1 + nb, 2 * bins), **f32)
    aext = torch.empty((nch, nb + 2, 2 * bins), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _tv_kernel()(
        *_ptrs(blocks_x, blocks_h, w0r, w0i, h0r, h0i), slots.data_ptr() + offset, stride,
        *_ptrs(fwd_table(pts, dev), post_ola_table(bins, dev), tails, outs, wfr, wfi, hfr,
               hfi, tailf, timeline, htimeline, aext),
        nb, nch, nparts, pts, float(b0_scale), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    return outs, (wfr, wfi), (hfr, hfi), tailf


def _one(planes: Cplx) -> Cplx:
    return planes[0][None], planes[1][None]


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
    outs, (wfr, wfi), tailf = _launch("stream_steps_fused", blocks[:, None], _one(w0),
                                      _one(h), b0_scale, tail[None], pts, dev)
    LAUNCHES += 1
    return outs[:, 0], (wfr[0], wfi[0]), tailf[0]


def stream_steps_fused_plain(blocks: torch.Tensor, w0: Cplx, h: Cplx,
                             b0_scale: float, tail: torch.Tensor, pts: int):
    """Plain PyTorch twin of the LTI scan: the batched twin at one channel."""
    outs, (wfr, wfi), tailf = stream_steps_fused_batched_plain(
        blocks[:, None], _one(w0), _one(h), b0_scale, tail[None], pts)
    return outs[:, 0], (wfr[0], wfi[0]), tailf[0]


def stream_steps_fused_batched(blocks: torch.Tensor, w0: Cplx, h: Cplx,
                               b0_scale: float, tails: torch.Tensor, pts: int):
    """Run an entire LTI streaming scan of C channels in one call.

    blocks: (nblocks, C, pts); w0, h: split (C, nparts, bins) windows and
    IR spectra, each channel in the single-channel layout; tails: (C, bins).
    Returns (outs (nblocks, C, pts), (wfr, wfi) (C, nparts, bins),
    tails_fin (C, bins)).
    """
    global BATCHED_LAUNCHES
    w0r, w0i = w0
    hr, hi = h
    _check_batched(blocks, w0r, w0i, hr, hi, tails, pts)
    dev = _build.launch_device("stream_steps_fused_batched",
                               (blocks, w0r, w0i, hr, hi, tails))
    if dev.type == "cpu":
        return stream_steps_fused_batched_plain(blocks, w0, h, b0_scale, tails, pts)
    got = _launch("stream_steps_fused_batched", blocks, w0, h, b0_scale, tails, pts, dev)
    BATCHED_LAUNCHES += 1
    return got


def _dense_frames(blocks: torch.Tensor, pts: int) -> Cplx:
    """Forward frames of blocks (nb, C, pts) as one product against the
    ``wfwd`` table: split (C, nb, bins)."""
    f = (blocks.to(torch.float32) @ fwd_table(pts, blocks.device)).transpose(0, 1)
    return f[..., :pts], f[..., pts:]


def _timeline(frames: Cplx, w0: Cplx) -> Cplx:
    """Per channel: the initial window, then the frames (C, nb, bins) ->
    split (C, nparts + nb, bins)."""
    return torch.cat([w0[0], frames[0]], 1), torch.cat([w0[1], frames[1]], 1)


def _post_ola_plain(acc_r, acc_i, tails, pts):
    """[acc_r | acc_i] @ wpost per channel, overlap-add with the carried
    tail, / pts: (C, nb, bins) accumulators -> (outs (nb, C, pts), final
    tails (C, pts))."""
    y = torch.cat([acc_r, acc_i], -1) @ post_table(pts, acc_r.device)   # (C, nb, 2b)
    prev = torch.cat([tails[:, None], y[:, :-1, pts:]], 1)
    return ((y[..., :pts] + prev) / pts).transpose(0, 1).contiguous(), y[:, -1, pts:]


def stream_steps_fused_batched_plain(blocks: torch.Tensor, w0: Cplx, h: Cplx,
                                     b0_scale: float, tails: torch.Tensor, pts: int):
    """Plain PyTorch twin of the batched LTI scan: the kernel's three steps
    with a leading channel axis, the MAC summed over partitions in the
    kernel's order (q ascending)."""
    return _lti_scan_plain(blocks, w0, h, b0_scale, tails, pts, _dense_frames, _post_ola_plain)


def _lti_scan_plain(blocks, w0: Cplx, h: Cplx, b0_scale: float, tails, pts: int,
                   frames, post_ola):
    """The batched LTI scan, block-parallel, around two transform steps:
    ``frames(blocks, pts)`` -> split (C, nb, bins) forward frames and
    ``post_ola(acc_r, acc_i, tails, pts)`` -> (outs (nb, C, pts), final
    tails (C, pts)). The dense twin and the split-scan twin
    (``ops/cuda/splitstep.py``) share it."""
    hr, hi = h
    nparts = hr.shape[1]
    nb = blocks.shape[0]
    tr, ti = _timeline(frames(blocks, pts), w0)                # (C, nparts+nb, b)
    acc_r = torch.zeros((hr.shape[0], nb, pts), dtype=torch.float32, device=blocks.device)
    acc_i = torch.zeros_like(acc_r)
    for q in range(nparts):
        xr, xi = tr[:, 1 + q:1 + q + nb], ti[:, 1 + q:1 + q + nb]
        acc_r += xr * hr[:, q, None] - xi * hi[:, q, None]
        acc_i += xr * hi[:, q, None] + xi * hr[:, q, None]
    acc_r[..., 0] = b0_scale * (tr[:, 1:, 0].unfold(1, nparts, 1) * hr[:, None, :, 0]).sum(-1)
    acc_i[..., 0] = b0_scale * (ti[:, 1:, 0].unfold(1, nparts, 1) * hi[:, None, :, 0]).sum(-1)
    outs, tailf = post_ola(acc_r, acc_i, tails, pts)
    return outs, (tr[:, nb:nb + nparts], ti[:, nb:nb + nparts]), tailf


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
    outs, (wfr, wfi), (hfr, hfi), tailf = _launch_tv(
        "stream_steps_fused_tv", blocks_x[:, None], blocks_h[:, None], _one(w0), _one(h0),
        int(wp2) % h0r.shape[0], b0_scale, tail[None], pts, dev)
    TV_LAUNCHES += 1
    return outs[:, 0], (wfr[0], wfi[0]), (hfr[0], hfi[0]), tailf[0]


def stream_steps_fused_tv_plain(blocks_x: torch.Tensor, blocks_h: torch.Tensor,
                                w0: Cplx, h0: Cplx, wp2: int, b0_scale: float,
                                tail: torch.Tensor, pts: int):
    """Plain PyTorch twin of the TV scan: the batched twin at one channel."""
    outs, (wfr, wfi), (hfr, hfi), tailf = stream_steps_fused_batched_tv_plain(
        blocks_x[:, None], blocks_h[:, None], _one(w0), _one(h0), wp2, b0_scale,
        tail[None], pts)
    return outs[:, 0], (wfr[0], wfi[0]), (hfr[0], hfi[0]), tailf[0]


def stream_steps_fused_batched_tv(blocks_x: torch.Tensor, blocks_h: torch.Tensor,
                                  w0: Cplx, h0: Cplx, wp2: Pointers, b0_scale: float,
                                  tails: torch.Tensor, pts: int):
    """Run an entire time-varying streaming scan of C channels in one call.

    blocks_x, blocks_h: (nblocks, C, pts); w0, h0: split (C, nparts, bins)
    windows and coefficient rings; wp2: the rings' pointer, one int shared
    by every channel or a length-C sequence; tails: (C, bins). Returns
    (outs (nblocks, C, pts), (wfr, wfi), (hfr, hfi), tails_fin): each
    channel's final ring has pointer (wp2_c - nblocks) mod nparts.
    """
    global BATCHED_TV_LAUNCHES
    w0r, w0i = w0
    h0r, h0i = h0
    _check_batched(blocks_x, w0r, w0i, h0r, h0i, tails, pts)
    if tuple(blocks_h.shape) != tuple(blocks_x.shape):
        raise ValueError(f"blocks_h must have the shape of blocks_x "
                         f"{tuple(blocks_x.shape)}, got {tuple(blocks_h.shape)}")
    wp2 = _channel_pointers(wp2, blocks_x.shape[1], h0r.shape[1])
    dev = _build.launch_device("stream_steps_fused_batched_tv",
                               (blocks_x, blocks_h, w0r, w0i, h0r, h0i, tails))
    if dev.type == "cpu":
        return stream_steps_fused_batched_tv_plain(blocks_x, blocks_h, w0, h0, wp2,
                                                   b0_scale, tails, pts)
    got = _launch_tv("stream_steps_fused_batched_tv", blocks_x, blocks_h, w0, h0, wp2,
                     b0_scale, tails, pts, dev)
    BATCHED_TV_LAUNCHES += 1
    return got


def _tv_rows(t, q, wp2, nparts: int) -> torch.Tensor:
    """Row of the coefficient timeline that ring slot q holds at block t:
    that of the last block s <= t with s = wp2 - q (mod nparts), at row
    s + nparts - 1 (rows [0, nparts-1) are pseudo-times -(nparts-1)..-1)."""
    return t - (t - wp2 + q) % nparts + nparts - 1


def stream_steps_fused_batched_tv_plain(blocks_x: torch.Tensor, blocks_h: torch.Tensor,
                                        w0: Cplx, h0: Cplx, wp2: Pointers,
                                        b0_scale: float, tails: torch.Tensor, pts: int):
    """Plain PyTorch twin of the batched TV scan, from the same timelines.

    Per channel c: x timeline rows [0, nparts) = w0_c, then block t's input
    frame at row nparts + t. h timeline: the initial ring in time order
    (row j = the frame of pseudo-time s = j - (nparts-1), ring slot
    (wp2_c - s) mod nparts), then block t's coefficient frame at row
    nparts - 1 + t. The MAC pairs window row q of block t with h timeline
    row ``_tv_rows(t, q, wp2_c)``, summed over q ascending as the kernel
    does; the final ring is the same gather at t = nblocks - 1.
    """
    return _tv_scan_plain(blocks_x, blocks_h, w0, h0, wp2, b0_scale, tails, pts,
                         _dense_frames, _post_ola_plain)


def _tv_scan_plain(blocks_x, blocks_h, w0: Cplx, h0: Cplx, wp2: Pointers, b0_scale: float,
                  tails, pts: int, frames, post_ola):
    """The batched TV scan around the two transform steps of
    ``_lti_scan_plain``."""
    h0r, h0i = h0
    nch, nparts = h0r.shape[:2]
    nb = blocks_x.shape[0]
    dev = blocks_x.device
    wp2 = _channel_pointers(wp2, nch, nparts)
    wp2 = torch.tensor(wp2 if isinstance(wp2, tuple) else (wp2,) * nch, device=dev)[:, None]
    ch = torch.arange(nch, device=dev)[:, None]
    tr, ti = _timeline(frames(blocks_x, pts), w0)              # (C, nparts+nb, b)
    slots = (wp2 - torch.arange(-(nparts - 1), 0, device=dev)) % nparts
    htr, hti = _timeline(frames(blocks_h, pts), (h0r[ch, slots], h0i[ch, slots]))
    t = torch.arange(nb, device=dev)
    acc_r = torch.zeros((nch, nb, pts), dtype=torch.float32, device=dev)
    acc_i = torch.zeros_like(acc_r)
    dc_r = torch.zeros((nch, nb), dtype=torch.float32, device=dev)
    dc_i = torch.zeros_like(dc_r)
    for q in range(nparts):
        xr, xi = tr[:, 1 + q:1 + q + nb], ti[:, 1 + q:1 + q + nb]
        rows = _tv_rows(t, q, wp2, nparts)                     # (C, nb)
        hr, hi = htr[ch, rows], hti[ch, rows]
        acc_r += xr * hr - xi * hi
        acc_i += xr * hi + xi * hr
        dc_r += xr[..., 0] * hr[..., 0]
        dc_i += xi[..., 0] * hi[..., 0]
    acc_r[..., 0] = b0_scale * dc_r
    acc_i[..., 0] = b0_scale * dc_i
    outs, tailf = post_ola(acc_r, acc_i, tails, pts)
    rows = _tv_rows(nb - 1, torch.arange(nparts, device=dev), wp2, nparts)   # (C, nparts)
    return (outs, (tr[:, nb:nb + nparts], ti[:, nb:nb + nparts]),
            (htr[ch, rows], hti[ch, rows]), tailf)
