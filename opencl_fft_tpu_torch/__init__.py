"""opencl_fft_tpu_torch — the PyTorch/CUDA port of opencl_fft_tpu.

It mirrors the JAX package's module layout. So far it holds the FFT surface
and the streaming convolution paths: complex and packed real FFTs
(``ops/fft.py``, ``ops/rfft.py``), whose power-of-two sizes 2^10..2^20 run
on a hand-written CUDA FFT on the card (``csrc/fft.cu``, wrapped by
``ops/cuda/vmemfft.py``: ``fft_vmem``, ``fft_vmem_front2``) and the rest on
``torch.fft``, with Bluestein for sizes that are not powers of two; the
``Clcfft`` and ``Clrfft`` classes and the ``ClfftProcessor`` and
``ClrfftProcessor`` opcode layers; the partitioned
engine (``ops/pconv.py``), LTI and time-varying, whose whole-scan streams
run on hand-written CUDA kernels for Hopper (``csrc/streamstep.cu``); the
direct FIR engine (``ops/dconv.py``), whose whole-scan stream runs on
``csrc/dstream.cu``; the ``Clpconv`` and ``Cldconv`` classes; the
``ClconvProcessor`` and ``CltvconvProcessor`` opcode layers; the batched
serving models (``models/``: ``Convolver``, ``TVConvolver``,
``MatrixConvolver``, ``BatchedFFT``), whose scans run on the batched
entries of ``csrc/streamstep.cu``; the chunked, offline and decomposed
engines (``pconv_chunk{,_tv}``, ``pconv_offline``, ``Convolver.render``,
``pconv_stream_batched_chunked``, ``convolve_oneshot``, the LTI
``stream_decomposed`` of ``ops/decomposed.py``), whose sliding MAC runs on
``csrc/slidemac.cu`` (``ops/cuda/slidemac.py``: ``chunk_mac``,
``macflow_lti``, ``macflow_lti_batched``); the time-varying decomposed
engine (``stream_decomposed`` with ``blocks_h``,
``stream_batched_tv_decomposed``, ``pconv_stream_batched_tv_chunked``,
``TVConvolver.stream_chunked``), whose TV sliding MAC runs on the same
source (``macflow_tv``, ``macflow_tv_batched``); the streams at partitions
above 2048, through the same whole-scan kernels under the split scans'
wrappers (``ops/cuda/splitstep.py``:
``stream_steps_fused_split{,_batched}{,_tv}``); the per-block steps
(``pconv_step{,_tv}``, ``Clpconv.convolution``, the opcode processors,
``Convolver.step``) and the crossfaded IR replacement (``XfadeState``,
``pconv_begin_xfade``, ``pconv_step_xfade``, ``Clpconv.push_ir_xfade``,
``ClconvProcessor.set_ir``, ``Convolver.set_ir``, ``MatrixConvolver.set_ir``),
whose block steps run on ``csrc/blockstep.cu`` (``ops/cuda/blockstep.py``:
``block_step_fused``, ``block_step_fwd_fused``, ``block_step_fwd_fused_tv``;
``ops/cuda/mac.py``: ``spectral_mac``) and, above pts 2048, on the
MAC-and-unpack entry of the same source (``block_mac_unpack``) before the
inverse FFT; the zero-latency convolver (``models/lowlatency.py``:
``ZeroLatencyConvolver``, ``plan_segments``; ``ClconvProcessor(parts=0)``);
the STFT layer (``ops/stft.py``: ``stft``, ``istft``, ``spectrogram``) on
the FFT kernel; state exchange with the JAX package (``interop.py``), a
crossfade in progress, a zero-latency stream, bf16-ring and float64 states
and the sharded state included; and scale-out on ``torch.distributed``
(``parallel/``: the (dp, tp) mesh, the sharded convolver, ``sharded_fft``,
``dist_fft``, the multi-rank dry run). bf16 rings and float64 compute
(``PconvConfig(ring_dtype="bf16")``, ``dtype="f64"``) take the plain
composition on either device: only float32 reaches the kernels.

Every engine takes an explicit device: a CUDA card, or the CPU when asked
for by name, where each kernel's plain PyTorch twin runs.
"""

from .api import Clcfft, Cldconv, Clpconv, Clrfft
from .interop import (dconv_state_from_numpy, dconv_state_to_numpy,
                      pconv_state_from_numpy, pconv_state_to_numpy,
                      xfade_state_from_numpy, xfade_state_to_numpy, zl_state_from_numpy,
                      zl_state_to_numpy)
from .ops.cuda.blockstep import (block_mac_unpack, block_mac_unpack_plain,
                                 block_step_fused, block_step_fused_plain,
                                 block_step_fwd_fused, block_step_fwd_fused_plain,
                                 block_step_fwd_fused_tv, block_step_fwd_fused_tv_plain)
from .ops.cuda.mac import spectral_mac, spectral_mac_plain
from .ops.cuda.dstream import dstream_steps, dstream_steps_plain, toeplitz_slabs
from .ops.cuda.slidemac import (chunk_mac, macflow_lti, macflow_lti_batched, macflow_tv,
                                macflow_tv_batched, slide_mac_plain, slide_mac_tv_plain)
from .ops.cuda.splitstep import (stream_steps_fused_split, stream_steps_fused_split_batched,
                                 stream_steps_fused_split_batched_plain,
                                 stream_steps_fused_split_batched_tv,
                                 stream_steps_fused_split_batched_tv_plain,
                                 stream_steps_fused_split_plain, stream_steps_fused_split_tv,
                                 stream_steps_fused_split_tv_plain)
from .models import (BatchedFFT, Convolver, MatrixConvolver, TVConvolver,
                     ZeroLatencyConvolver, batched_state, plan_segments)
from .ops.cuda.streamstep import (stream_steps_fused, stream_steps_fused_batched,
                                  stream_steps_fused_batched_plain,
                                  stream_steps_fused_batched_tv,
                                  stream_steps_fused_batched_tv_plain,
                                  stream_steps_fused_plain, stream_steps_fused_tv,
                                  stream_steps_fused_tv_plain)
from .ops.decomposed import stream_batched_tv_decomposed, stream_decomposed
from .ops.dconv import (DconvConfig, DconvState, convolve_direct, dconv_init,
                        dconv_step, dconv_step_tv, dconv_stream)
from .ops.cuda.vmemfft import (fft_vmem, fft_vmem_front2, fft_vmem_front2_plain,
                               fft_vmem_plain)
from .ops.fft import cfft, cfft_split, fft, fft_split, fft_unnormalized, ifft
from .ops.pconv import (PconvConfig, PconvState, XfadeState, convolve, convolve_oneshot,
                        pconv_begin_xfade, pconv_chunk, pconv_chunk_tv, pconv_init,
                        pconv_offline, pconv_step, pconv_step_tv, pconv_step_xfade,
                        pconv_stream, pconv_stream_batched, pconv_stream_batched_chunked,
                        pconv_stream_batched_tv, pconv_stream_batched_tv_chunked,
                        pconv_stream_tv, push_ir)
from .ops.rfft import (irfft, irfft_split, pack_forward, packed_to_standard, rfft,
                       rfft_split, standard_to_packed, unpack_inverse)
from .ops.stft import istft, spectrogram, stft
from .stream import (ClconvProcessor, ClfftProcessor, ClrfftProcessor,
                     CltvconvProcessor)
from .utils.devices import get_device
from .utils.errors import (ArgumentError, DeviceError, FftError, SizeError,
                           Status, error_string)
from .utils.numerics import np2

__version__ = "0.1.0"

__all__ = [
    "Clcfft", "Clrfft", "Clpconv", "Cldconv",
    "ClfftProcessor", "ClrfftProcessor", "ClconvProcessor", "CltvconvProcessor",
    "fft_split", "cfft_split", "rfft_split", "irfft_split",
    "cfft", "fft", "ifft", "fft_unnormalized", "rfft", "irfft",
    "packed_to_standard", "standard_to_packed", "pack_forward", "unpack_inverse",
    "fft_vmem", "fft_vmem_plain", "fft_vmem_front2", "fft_vmem_front2_plain",
    "PconvConfig", "PconvState", "pconv_init", "push_ir", "pconv_step",
    "pconv_step_tv", "pconv_stream", "pconv_stream_tv", "convolve",
    "pconv_stream_batched", "pconv_stream_batched_tv",
    "pconv_chunk", "pconv_chunk_tv", "pconv_offline", "pconv_stream_batched_chunked",
    "convolve_oneshot", "stream_decomposed", "stream_batched_tv_decomposed",
    "pconv_stream_batched_tv_chunked",
    "XfadeState", "pconv_begin_xfade", "pconv_step_xfade",
    "Convolver", "TVConvolver", "MatrixConvolver", "BatchedFFT", "batched_state",
    "ZeroLatencyConvolver", "plan_segments", "stft", "istft", "spectrogram",
    "DconvConfig", "DconvState", "dconv_init", "dconv_step", "dconv_step_tv",
    "dconv_stream", "convolve_direct",
    "stream_steps_fused", "stream_steps_fused_plain",
    "stream_steps_fused_tv", "stream_steps_fused_tv_plain",
    "stream_steps_fused_batched", "stream_steps_fused_batched_plain",
    "stream_steps_fused_batched_tv", "stream_steps_fused_batched_tv_plain",
    "dstream_steps", "dstream_steps_plain", "toeplitz_slabs",
    "chunk_mac", "macflow_lti", "macflow_lti_batched", "slide_mac_plain",
    "macflow_tv", "macflow_tv_batched", "slide_mac_tv_plain",
    "stream_steps_fused_split", "stream_steps_fused_split_plain",
    "stream_steps_fused_split_tv", "stream_steps_fused_split_tv_plain",
    "stream_steps_fused_split_batched", "stream_steps_fused_split_batched_plain",
    "stream_steps_fused_split_batched_tv", "stream_steps_fused_split_batched_tv_plain",
    "spectral_mac", "spectral_mac_plain", "block_step_fused", "block_step_fused_plain",
    "block_step_fwd_fused", "block_step_fwd_fused_plain",
    "block_step_fwd_fused_tv", "block_step_fwd_fused_tv_plain",
    "block_mac_unpack", "block_mac_unpack_plain",
    "pconv_state_from_numpy", "pconv_state_to_numpy",
    "xfade_state_from_numpy", "xfade_state_to_numpy",
    "dconv_state_from_numpy", "dconv_state_to_numpy",
    "zl_state_from_numpy", "zl_state_to_numpy",
    "get_device", "np2",
    "Status", "error_string", "FftError", "DeviceError", "SizeError",
    "ArgumentError",
]
