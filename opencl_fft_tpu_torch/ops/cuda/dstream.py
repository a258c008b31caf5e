"""Whole-scan direct FIR convolution: the CUDA kernel of ``csrc/dstream.cu``
and its plain PyTorch twin.

Counterpart of ``opencl_fft_tpu/ops/pallas/dstream.py:dstream_steps``: each
output block is a block-Toeplitz product of the last P+1 input blocks
against constant slabs built from the coefficients,

    out_g = [x_{g-P} .. x_g] @ T,   T stacked as ((P+1)*vsize, vsize).

Row g of the left operand is the sequence seq = [P context blocks; new
blocks] read from g*vsize for (P+1)*vsize samples, so the whole scan is one
strided product (the twin, ``dstream_steps_plain``). With s the flattened
seq and k the time-reversed taps it is the valid correlation

    out[g*vsize + n] = sum_{h < irsize} s[g*vsize + pad + off + n + h] * k[h],

pad = P*vsize - irsize, which the CUDA kernel computes directly from the
coefficients: the taps' work only, no slabs.

``dstream_steps`` takes the coefficients; it runs the CUDA kernel for CUDA
tensors and the twin on ``toeplitz_slabs`` for CPU tensors; anything else
raises. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...utils.numerics import exact_matmul
from . import _build

LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("dstream").dstream_steps_f32
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 3 + [i] * 5 + [p]
    fn.restype = ctypes.c_int
    return fn


def context_blocks(irsize: int, vsize: int) -> int:
    """P: the input blocks before the current one that an output block
    reads, ceil(irsize / vsize)."""
    return -(-irsize // vsize)


def toeplitz_slabs(coefs: torch.Tensor, irsize: int, vsize: int,
                   off: int) -> torch.Tensor:
    """((P+1)*vsize, vsize) stacked Toeplitz slabs from the coefficient
    vector: T[j, n] = k[j - off - pad - n], with k the time-reversed IR
    (k[h] = ir[irsize-1-h], zero outside [0, irsize)), P =
    ``context_blocks(irsize, vsize)`` and pad = P*vsize - irsize the
    samples of the context that no tap reaches. Then the context row
    d = [x_{g-P} .. x_g] gives out_g[n] = sum_j d[j] T[j, n] =
    sum_h d[pad + n + off + h] k[h], the contraction of ``dconv_step``;
    ``off`` is 1 for the standard alignment and 0 for ``delay_compat``.
    At pad = 0 this is the JAX package's ``toeplitz_slabs``."""
    p = context_blocks(irsize, vsize)
    pad = p * vsize - irsize
    ir = coefs[:irsize]
    j = torch.arange((p + 1) * vsize, device=coefs.device)[:, None]
    n = torch.arange(vsize, device=coefs.device)[None, :]
    h = j - off - pad - n
    valid = (h >= 0) & (h < irsize)
    taps = ir[(irsize - 1 - h).clamp(0, irsize - 1)]
    return torch.where(valid, taps, torch.zeros((), dtype=ir.dtype, device=ir.device))


def _check_slabs(seq, slabs, vsize):
    if slabs.dim() != 2 or slabs.shape[1] != vsize or slabs.shape[0] % vsize \
            or slabs.shape[0] < vsize:
        raise ValueError(f"slabs must be ((P+1)*{vsize}, {vsize}), got {tuple(slabs.shape)}")
    return _check_seq(seq, slabs.shape[0] // vsize - 1, vsize)


def _check_seq(seq, p, vsize):
    if seq.dim() != 2 or seq.shape[1] != vsize:
        raise ValueError(f"seq must be (P + nblocks, {vsize}), got {tuple(seq.shape)}")
    nb = seq.shape[0] - p
    if nb < 1:
        raise ValueError(f"seq holds {seq.shape[0]} blocks: the {p} context blocks "
                         f"of the taps and no new block")
    return nb


def dstream_steps(seq: torch.Tensor, ir: torch.Tensor, vsize: int, off: int) -> torch.Tensor:
    """Run an entire direct-FIR scan in one call.

    seq: (P + nblocks, vsize), the P = ``context_blocks(irsize, vsize)``
    context blocks, oldest first, then the new blocks; ir: (irsize,) the
    coefficients in time order; off: 1 for the standard alignment, 0 for
    ``delay_compat``. Returns outs (nblocks, vsize), the same as
    ``dstream_steps_plain(seq, toeplitz_slabs(ir, irsize, vsize, off),
    vsize)``. The caller rebuilds the ring from seq.
    """
    global LAUNCHES
    if ir.dim() != 1 or ir.shape[0] < 1:
        raise ValueError(f"ir must be (irsize,), got {tuple(ir.shape)}")
    if off not in (0, 1):
        raise ValueError(f"off must be 0 or 1, got {off}")
    irsize = ir.shape[0]
    nb = _check_seq(seq, context_blocks(irsize, vsize), vsize)
    dev = _build.launch_device("dstream_steps", (seq, ir))
    if dev.type == "cpu":
        return dstream_steps_plain(seq, toeplitz_slabs(ir, irsize, vsize, off), vsize)
    outs = torch.empty((nb, vsize), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel()(seq.data_ptr(), ir.data_ptr(), outs.data_ptr(), nb, irsize, vsize, off,
                    dev.index, stream)
    if err != 0:
        raise RuntimeError(f"dstream_steps: CUDA error {err} at launch")
    LAUNCHES += 1
    return outs


def context_rows(seq: torch.Tensor, p: int, vsize: int) -> torch.Tensor:
    """(nblocks, (P+1)*vsize) view of seq ((P + nblocks, vsize),
    contiguous) whose row g is [x_{g-P} .. x_g]: seq read with row stride
    vsize."""
    return seq.as_strided((seq.shape[0] - p, (p + 1) * vsize), (vsize, 1))


def dstream_steps_plain(seq: torch.Tensor, slabs: torch.Tensor, vsize: int) -> torch.Tensor:
    """Plain PyTorch twin of the CUDA kernel, as the TPU kernel computes
    it: the strided context view of seq @ slabs (``toeplitz_slabs``)."""
    _check_slabs(seq, slabs, vsize)
    p = slabs.shape[0] // vsize - 1
    seq = seq.to(torch.float32).contiguous()
    return exact_matmul(context_rows(seq, p, vsize), slabs.to(torch.float32))
