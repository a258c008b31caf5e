"""Batched engine models, the deployment-shaped surfaces.

Convolver       — batched LTI convolution (clconv at scale)
TVConvolver     — batched time-varying convolution (cltvconv at scale)
MatrixConvolver — true-stereo / matrix convolution on one Convolver
BatchedFFT      — batched transforms (clfft at scale)
"""

from .convolver import (BatchedFFT, Convolver, MatrixConvolver, TVConvolver,
                        batched_state)

__all__ = ["BatchedFFT", "Convolver", "MatrixConvolver", "TVConvolver",
           "batched_state"]
