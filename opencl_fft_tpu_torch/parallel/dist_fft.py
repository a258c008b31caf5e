"""One large DFT sharded over a mesh axis: the six-step FFT with three
global transposes, each one ``all_to_all_single`` over the axis's group.

Counterpart of ``opencl_fft_tpu/parallel/dist_fft.py``. ``sharded_fft``
scales the batch axis; this scales the transform itself. With n = n1 * n2
and x viewed as (j1, j2) row-major,

    X[k2*n1 + k1] = sum_{j2} W_n^{j2 k1} W_{n2}^{j2 k2} [sum_{j1} x[j1, j2] W_{n1}^{j1 k1}]

so: transpose -> DFT(n1) -> twiddle -> transpose -> DFT(n2) -> transpose.
Each transpose moves n/d elements a rank. Input and output are in natural
order, block-sharded over the axis: rank i of the axis holds elements
[i n/d, (i+1) n/d). The local DFTs are ``fft_split``, so on a card a
float32 transform of 2^10..2^20 points runs the port's FFT kernels.
``ALL_TO_ALLS`` counts the all_to_all calls on this rank.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.cplx import Cplx, from_complex, to_complex
from ..ops.fft import fft_split
from ..utils.numerics import ilog2, is_pow2
from .mesh import Mesh

ALL_TO_ALLS = 0


def _factor_for_mesh(n: int, d: int) -> Tuple[int, int]:
    """n = n1 * n2 with d dividing both factors (each transpose reshards
    one axis over the mesh), n1 as close to sqrt(n) as that allows."""
    if not is_pow2(n):
        raise ValueError(f"distributed FFT needs a power-of-two size, got {n}")
    n1 = 1 << (ilog2(n) // 2)
    while n1 < n and n1 % d:
        n1 <<= 1
    n2 = n // n1
    if n1 % d or n2 % d or n2 < 1:
        raise ValueError(f"cannot shard a {n}-point transform over {d} ranks "
                         f"(need d | n1 and d | n2)")
    return n1, n2


def _fourstep_twiddle_np(n1: int, n2: int, sign: int) -> Tuple[np.ndarray, np.ndarray]:
    """The twiddle exp(sign 2 pi i j2 k1 / n), (n2, n1), built in float64
    and rounded once to float32, split."""
    ph = np.outer(np.arange(n2, dtype=np.float64), np.arange(n1, dtype=np.float64))
    w = np.exp(sign * 2j * np.pi * ph / (n1 * n2))
    return w.real.astype(np.float32), w.imag.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _twiddle_rows(n1: int, n2: int, sign: int, lo: int, count: int, device: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows [lo, lo + count) (this rank's j2) of the twiddle on ``device``,
    built once a shape and device; the eight last used stay cached."""
    return tuple(torch.from_numpy(np.ascontiguousarray(t[lo:lo + count])).to(device)
                 for t in _fourstep_twiddle_np(n1, n2, sign))


def _transpose(a: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The global transpose of a matrix whose rows are block-sharded over
    ``axis``: this rank's (..., R/d, C) rows of (R, C) in, its (..., C/d, R)
    rows of the transpose out. One all_to_all: column block j goes to rank
    j, and the blocks that arrive stack in rank order (JAX ``all_to_all``
    with split_axis the columns, concat_axis the rows, tiled, then
    ``swapaxes``)."""
    global ALL_TO_ALLS
    d = mesh.shape[axis]
    *lead, r, c = a.shape
    send = a.reshape(*lead, r, d, c // d).movedim(-2, 0).contiguous()   # (d, ..., r, c/d)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.groups[axis])
    ALL_TO_ALLS += 1
    return recv.movedim(0, -3).reshape(*lead, d * r, c // d).transpose(-1, -2).contiguous()


def dist_fft_split(x: Cplx, mesh: Mesh, axis: str = "tp", sign: int = -1,
                   impl: str = "auto") -> Cplx:
    """Unnormalized DFT over the last axis of a split pair sharded over
    mesh axis ``axis``: x is this rank's (..., n/d) block of the input
    (leading axes replicated), computed in float32. Returns this rank's
    block of the natural-order spectrum."""
    re, im = (t.to(torch.float32) for t in x)
    d = mesh.shape[axis]
    n = re.shape[-1] * d
    n1, n2 = _factor_for_mesh(n, d)
    lead = re.shape[:-1]
    # re and im stacked as one leading axis: one all_to_all a transpose
    z = torch.stack([re, im]).reshape(2, *lead, n1 // d, n2)   # (j1 block, j2)
    z = _transpose(z, mesh, axis)                              # (j2 block, j1)
    r, i = fft_split((z[0], z[1]), sign, impl)                 # over j1 -> k1
    twr, twi = _twiddle_rows(n1, n2, sign, mesh.coords[axis] * (n2 // d), n2 // d,
                             re.device)                       # global j2 rows
    z = _transpose(torch.stack([r * twr - i * twi, r * twi + i * twr]), mesh, axis)
    r, i = fft_split((z[0], z[1]), sign, impl)                 # (k1 block, j2) -> k2
    z = _transpose(torch.stack([r, i]), mesh, axis)            # (k2 block, k1)
    return z[0].reshape(*lead, n // d), z[1].reshape(*lead, n // d)


def dist_fft(x, mesh: Mesh, axis: str = "tp", sign: int = -1, impl: str = "auto"
             ) -> torch.Tensor:
    """Complex convenience wrapper at the host boundary: x is the whole
    (..., n) complex array on every rank (numpy or a tensor); each rank
    transforms its block and gathers the others'. Returns the whole
    complex64 spectrum on ``mesh.device``."""
    d = mesh.shape[axis]
    x = torch.as_tensor(x, dtype=torch.complex64, device=mesh.device)
    n = x.shape[-1]
    _factor_for_mesh(n, d)
    i = mesh.coords[axis]
    re, im = from_complex(x[..., i * n // d:(i + 1) * n // d])
    mine = torch.stack(dist_fft_split((re, im), mesh, axis, sign, impl))
    blocks = [torch.empty_like(mine) for _ in range(d)]
    dist.all_gather(blocks, mine, group=mesh.groups[axis])
    both = torch.cat(blocks, -1)
    return to_complex((both[0], both[1]))
