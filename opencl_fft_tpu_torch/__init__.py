"""opencl_fft_tpu_torch — the PyTorch/CUDA port of opencl_fft_tpu.

It mirrors the JAX package's module layout. So far it holds the LTI
streaming-convolution path: packed real FFTs on ``torch.fft``, the
partitioned-convolution engine (``ops/pconv.py``), whose whole-scan stream
runs on a hand-written CUDA kernel for Hopper (``csrc/streamstep.cu``),
the ``Clpconv`` class, the ``ClconvProcessor`` opcode layer, and state
exchange with the JAX package (``interop.py``).

Every engine takes an explicit device: a CUDA card, or the CPU when asked
for by name, where each kernel's plain PyTorch twin runs.
"""

from .api import Clpconv
from .interop import pconv_state_from_numpy, pconv_state_to_numpy
from .ops.cuda.streamstep import stream_steps_fused, stream_steps_fused_plain
from .ops.fft import cfft_split, fft_split
from .ops.pconv import (PconvConfig, PconvState, convolve, pconv_init,
                        pconv_step, pconv_stream, push_ir)
from .ops.rfft import irfft_split, pack_forward, rfft_split, unpack_inverse
from .stream import ClconvProcessor
from .utils.devices import get_device
from .utils.errors import (ArgumentError, DeviceError, FftError, SizeError,
                           Status, error_string)
from .utils.numerics import np2

__version__ = "0.1.0"

__all__ = [
    "Clpconv", "ClconvProcessor",
    "fft_split", "cfft_split", "rfft_split", "irfft_split",
    "pack_forward", "unpack_inverse",
    "PconvConfig", "PconvState", "pconv_init", "push_ir", "pconv_step",
    "pconv_stream", "convolve",
    "stream_steps_fused", "stream_steps_fused_plain",
    "pconv_state_from_numpy", "pconv_state_to_numpy",
    "get_device", "np2",
    "Status", "error_string", "FftError", "DeviceError", "SizeError",
    "ArgumentError",
]
