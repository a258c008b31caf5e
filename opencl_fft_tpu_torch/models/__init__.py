"""Batched engine models, the deployment-shaped surfaces.

Convolver            — batched LTI convolution (clconv at scale)
TVConvolver          — batched time-varying convolution (cltvconv at scale)
MatrixConvolver      — true-stereo / matrix convolution on one Convolver
BatchedFFT           — batched transforms (clfft at scale)
ZeroLatencyConvolver — streaming convolution with no added latency
                       (non-uniform partitions, ``plan_segments``)
"""

from .convolver import (BatchedFFT, Convolver, MatrixConvolver, TVConvolver,
                        batched_state)
from .lowlatency import Segment, ZeroLatencyConvolver, ZLState, plan_segments

__all__ = ["BatchedFFT", "Convolver", "MatrixConvolver", "TVConvolver",
           "batched_state", "Segment", "ZeroLatencyConvolver", "ZLState", "plan_segments"]
