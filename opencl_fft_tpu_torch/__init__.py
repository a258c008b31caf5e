"""opencl_fft_tpu_torch — the PyTorch/CUDA port of opencl_fft_tpu.

It mirrors the JAX package's module layout. So far it holds the streaming
convolution paths: packed real FFTs on ``torch.fft``; the partitioned
engine (``ops/pconv.py``), LTI and time-varying, whose whole-scan streams
run on hand-written CUDA kernels for Hopper (``csrc/streamstep.cu``); the
direct FIR engine (``ops/dconv.py``), whose whole-scan stream runs on
``csrc/dstream.cu``; the ``Clpconv`` and ``Cldconv`` classes; the
``ClconvProcessor`` and ``CltvconvProcessor`` opcode layers; the batched
serving models (``models/``: ``Convolver``, ``TVConvolver``,
``MatrixConvolver``, ``BatchedFFT``), whose scans run on the batched
entries of ``csrc/streamstep.cu``; and state exchange with the JAX package
(``interop.py``).

Every engine takes an explicit device: a CUDA card, or the CPU when asked
for by name, where each kernel's plain PyTorch twin runs.
"""

from .api import Cldconv, Clpconv
from .interop import (dconv_state_from_numpy, dconv_state_to_numpy,
                      pconv_state_from_numpy, pconv_state_to_numpy)
from .ops.cuda.dstream import dstream_steps, dstream_steps_plain, toeplitz_slabs
from .models import (BatchedFFT, Convolver, MatrixConvolver, TVConvolver,
                     batched_state)
from .ops.cuda.streamstep import (stream_steps_fused, stream_steps_fused_batched,
                                  stream_steps_fused_batched_plain,
                                  stream_steps_fused_batched_tv,
                                  stream_steps_fused_batched_tv_plain,
                                  stream_steps_fused_plain, stream_steps_fused_tv,
                                  stream_steps_fused_tv_plain)
from .ops.dconv import (DconvConfig, DconvState, convolve_direct, dconv_init,
                        dconv_step, dconv_step_tv, dconv_stream)
from .ops.fft import cfft_split, fft_split
from .ops.pconv import (PconvConfig, PconvState, convolve, pconv_init,
                        pconv_step, pconv_step_tv, pconv_stream,
                        pconv_stream_batched, pconv_stream_batched_tv,
                        pconv_stream_tv, push_ir)
from .ops.rfft import irfft_split, pack_forward, rfft_split, unpack_inverse
from .stream import ClconvProcessor, CltvconvProcessor
from .utils.devices import get_device
from .utils.errors import (ArgumentError, DeviceError, FftError, SizeError,
                           Status, error_string)
from .utils.numerics import np2

__version__ = "0.1.0"

__all__ = [
    "Clpconv", "Cldconv", "ClconvProcessor", "CltvconvProcessor",
    "fft_split", "cfft_split", "rfft_split", "irfft_split",
    "pack_forward", "unpack_inverse",
    "PconvConfig", "PconvState", "pconv_init", "push_ir", "pconv_step",
    "pconv_step_tv", "pconv_stream", "pconv_stream_tv", "convolve",
    "pconv_stream_batched", "pconv_stream_batched_tv",
    "Convolver", "TVConvolver", "MatrixConvolver", "BatchedFFT", "batched_state",
    "DconvConfig", "DconvState", "dconv_init", "dconv_step", "dconv_step_tv",
    "dconv_stream", "convolve_direct",
    "stream_steps_fused", "stream_steps_fused_plain",
    "stream_steps_fused_tv", "stream_steps_fused_tv_plain",
    "stream_steps_fused_batched", "stream_steps_fused_batched_plain",
    "stream_steps_fused_batched_tv", "stream_steps_fused_batched_tv_plain",
    "dstream_steps", "dstream_steps_plain", "toeplitz_slabs",
    "pconv_state_from_numpy", "pconv_state_to_numpy",
    "dconv_state_from_numpy", "dconv_state_to_numpy",
    "get_device", "np2",
    "Status", "error_string", "FftError", "DeviceError", "SizeError",
    "ArgumentError",
]
