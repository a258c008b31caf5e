"""Whole-scan LTI streaming convolution: the CUDA kernel of
``csrc/streamstep.cu`` and its plain PyTorch twin.

Counterpart of ``opencl_fft_tpu/ops/pallas/streamstep.py:stream_steps_fused``,
with the same signature and results: every block of the scan goes through
forward rFFT (one matmul against the ``wfwd`` table), a one-frame window
slide, the frequency-delay-line complex MAC (bin 0 componentwise, times
``b0_scale``), one matmul against ``wpost`` and the overlap-add / pts.

The scan is computed block-parallel: all input blocks are known up front,
so the forward frames of the whole scan form one timeline behind the
initial window, and block t's window is timeline rows [t+1, t+1+nparts).

``stream_steps_fused`` runs the CUDA kernel for CUDA tensors and the twin
for CPU tensors; anything else raises. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..cplx import Cplx
from . import _build
from .tables import fwd_table, post_ola_table, post_table

LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("streamstep").stream_steps_fused_f32
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 14 + [i, i, i, ctypes.c_float, i, p]
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
    args = (blocks, w0r, w0i, hr, hi, tail)
    dev = blocks.device
    if any(t.device != dev for t in args):
        raise ValueError("stream_steps_fused: all tensors must be on one device")
    if dev.type == "cpu":
        return stream_steps_fused_plain(blocks, w0, h, b0_scale, tail, pts)
    if dev.type != "cuda":
        raise ValueError(f"stream_steps_fused: no kernel for device {dev}")
    for t in args:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("stream_steps_fused: CUDA tensors must be "
                             "contiguous float32")
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
    y = torch.cat([acc_r, acc_i], dim=1) @ post_table(bins, dev)   # (nb, 2b)
    prev = torch.cat([tail[None], y[:-1, pts:]])
    outs = (y[:, :pts] + prev) / pts
    return outs, (tr[nb:nb + nparts], ti[nb:nb + nparts]), y[-1, pts:]
