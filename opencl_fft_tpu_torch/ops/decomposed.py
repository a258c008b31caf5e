"""Decomposed (batch-transform) streaming engine, LTI and time-varying.

Counterpart of ``opencl_fft_tpu/ops/decomposed.py``. When every block of a
stream is known up front, the sequential per-block scan is not needed: the
frequency-delay-line MAC is a pure function of the frame-spectrum
timelines, so ``stream_decomposed`` and ``stream_batched_tv_decomposed``

  1. forward-transform all blocks in one product (both operands of a
     time-varying (TV) stream in the same product),
  2. run the sliding MAC over the timelines (``ops/cuda/slidemac.py``:
     ``macflow_lti`` for LTI, ``macflow_tv{,_batched}`` for TV; the CUDA
     kernels for CUDA tensors, their plain twins for CPU tensors),
  3. inverse-transform all accumulators at once with a vectorized
     overlap-add, and
  4. rebuild the ring state from the timelines' tails.

Steps 2–4 run in ``ops/pconv._timeline_engine``, which the offline and
chunked paths share; this module gives it the frames and the MAC.

The TV pairing (pinned against the sequential scan by the tests): the
input ring pointer wp increments and the coefficient ring pointer wp2
decrements a block (cl_conv.cpp:516-519), which reduces to a closed form
over frame times. With X_a the input frame of block a and H_b the
coefficient frame of block b (b < 0: the pre-call ring content, the
``_h_prefix_rows`` of the h timeline),

    out[t] = sum over a in [t-nparts+1, t] of X_a (*) H_{t - ((a + c) mod nparts)}

with the ring phase c = (nparts-1 - wp2) mod nparts. The JAX kernel takes
only c = 0 (mod 8) and sends other phases to XLA gathers; here every phase
runs the kernel.

Outputs match the sequential scan within float32 reduction-order
tolerance, and chained calls match one call. These are explicit entry
points: the streams keep their whole-scan kernels, which take every
partition size on the card (the split scans above pts 2048).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import pconv as P
from .cuda.slidemac import macflow_lti, macflow_tv, macflow_tv_batched


def _tv_frames(cfg: P.PconvConfig, blocks_x: torch.Tensor, blocks_h: torch.Tensor):
    """Both operands' frames from one forward product: (fr, fi), each (nb,
    2, [C,] bins) with operand 0 the input and 1 the coefficients."""
    return P._forward_partition(cfg, torch.stack([blocks_x.to(torch.float32),
                                                  blocks_h.to(torch.float32)], 1))


def _phase(cfg: P.PconvConfig, state: P.PconvState) -> int:
    """The coefficient ring's phase c = (nparts-1 - wp2) mod nparts, of a
    pointer shared by every channel."""
    if isinstance(state.wp2, tuple):
        raise ValueError("this engine needs ring pointers shared by every channel "
                         "(ints), got per-channel pointers")
    return (cfg.nparts - 1 - state.wp2) % cfg.nparts


def stream_decomposed(cfg: P.PconvConfig, state: P.PconvState, blocks_x: torch.Tensor,
                      blocks_h: Optional[torch.Tensor] = None
                      ) -> Tuple[P.PconvState, torch.Tensor]:
    """Process nb blocks with no sequential dependence, LTI when blocks_h
    is None and time-varying otherwise: blocks_x (and blocks_h) (nb, pts)
    -> outs (nb, pts).

    A drop-in for ``pconv_stream`` / ``pconv_stream_tv``: the same state in
    and out (chained calls match one call), outputs equal to the sequential
    scan within float32 reduction-order tolerance. Both operands of a TV
    stream go through one forward product.
    """
    if blocks_h is None:
        P._check_blocks(cfg, blocks_x, "blocks_x")
    else:
        P._check_pair(cfg, blocks_x, blocks_h)
    nb, pts = blocks_x.shape
    if nb == 0:
        return state, blocks_x.new_zeros((0, pts), dtype=torch.float32)
    b0 = cfg.b0_scale
    if blocks_h is None:
        fxr, fxi = P._forward_partition(cfg, blocks_x)        # (nb, bins)
        h = (state.spec_h_re, state.spec_h_im)
        return P._timeline_engine(cfg, state, fxr, fxi,
                                  lambda tl: macflow_lti(tl, h, nb, b0))
    fr, fi = _tv_frames(cfg, blocks_x, blocks_h)              # (nb, 2, bins)
    c = _phase(cfg, state)
    return P._timeline_engine(cfg, state, fr[:, 0], fi[:, 0],
                              lambda xtl, htl: macflow_tv(xtl, htl, nb, cfg.nparts, b0, c),
                              (fr[:, 1], fi[:, 1]))


def stream_batched_tv_decomposed(cfg: P.PconvConfig, state: P.PconvState,
                                 blocks_x: torch.Tensor, blocks_h: torch.Tensor
                                 ) -> Tuple[P.PconvState, torch.Tensor]:
    """Batched (multi-channel) time-varying decomposed streaming: blocks_x
    and blocks_h (nb, C, pts) -> outs (nb, C, pts) on a batched state
    (``models.batched_state``) whose ring pointers are shared by every
    channel (ints; per-channel pointers raise ValueError).

    The per-channel form of ``stream_decomposed``'s TV path: one forward
    product over every block, operand and channel, one ``macflow_tv_batched``
    launch (the phase is shared), one inverse transform and the per-channel
    ring rebuilds with the shared pointer walk.
    """
    P._check_pair(cfg, blocks_x, blocks_h, P._batched_channels(state))
    nb, nch, pts = blocks_x.shape
    c = _phase(cfg, state)
    if nb == 0:
        return state, blocks_x.new_zeros((0, nch, pts), dtype=torch.float32)
    fr, fi = (f.permute(1, 2, 0, 3) for f in _tv_frames(cfg, blocks_x, blocks_h))
    state, outs = P._timeline_engine(                         # frames (2, C, nb, bins)
        cfg, state, fr[0], fi[0],
        lambda xtl, htl: macflow_tv_batched(xtl, htl, nb, cfg.nparts, cfg.b0_scale, c),
        (fr[1], fi[1]))
    return state, outs.transpose(0, 1).contiguous()
