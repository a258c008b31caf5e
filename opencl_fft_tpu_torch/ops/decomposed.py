"""Decomposed (batch-transform) streaming engine, LTI form.

Counterpart of ``opencl_fft_tpu/ops/decomposed.py``. When every block of a
stream is known up front, the sequential per-block scan is not needed: the
frequency-delay-line MAC is a pure function of the frame-spectrum timeline,
so ``stream_decomposed``

  1. forward-transforms all blocks in one product,
  2. runs the sliding MAC over the timeline (``macflow_lti``,
     ``ops/cuda/slidemac.py``: the CUDA kernel for CUDA tensors, its plain
     twin for CPU tensors),
  3. inverse-transforms all accumulators at once with a vectorized
     overlap-add, and
  4. rebuilds the ring state from the timeline's tail.

Steps 2–4 run in ``ops/pconv._timeline_engine``, which the offline and
chunked paths share; this module gives it the frames and ``macflow_lti``
as its MAC.

Outputs match the sequential scan within float32 reduction-order
tolerance, and chained calls match one call. It is an explicit entry
point: ``pconv_stream`` keeps its whole-scan kernel, which has no VMEM
ceiling on the card. The time-varying form (``blocks_h``) and
``stream_batched_tv_decomposed`` are not ported yet (ROADMAP queue 1
item 10).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import pconv as P
from .cuda.slidemac import macflow_lti


def stream_decomposed(cfg: P.PconvConfig, state: P.PconvState, blocks_x: torch.Tensor,
                      blocks_h: Optional[torch.Tensor] = None
                      ) -> Tuple[P.PconvState, torch.Tensor]:
    """Process nb LTI blocks with no sequential dependence: blocks_x
    (nb, pts) -> outs (nb, pts).

    A drop-in for ``pconv_stream``: the same state in and out (chained
    calls match one call), outputs equal to the sequential scan within
    float32 reduction-order tolerance. ``blocks_h`` (the time-varying form)
    raises NotImplementedError.
    """
    if blocks_h is not None:
        raise NotImplementedError(
            "the time-varying decomposed engine (stream_decomposed with blocks_h) is "
            "not ported yet (ROADMAP queue 1 item 10)")
    P._check_blocks(cfg, blocks_x, "blocks_x", scan=False)
    nb, pts = blocks_x.shape
    if nb == 0:
        return state, blocks_x.new_zeros((0, pts), dtype=torch.float32)
    fxr, fxi = P._forward_partition(cfg, blocks_x)            # (nb, bins)
    h = (state.spec_h_re, state.spec_h_im)
    return P._timeline_engine(cfg, state, fxr, fxi,
                              lambda tl: macflow_lti(tl, h, nb, cfg.b0_scale))
