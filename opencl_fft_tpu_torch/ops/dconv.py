"""Direct time-domain FIR convolution with a delay line.

Counterpart of ``opencl_fft_tpu/ops/dconv.py`` (parity with ``Cldconv``,
``cl_dconv.h:17-66``): a circular delay line of ``irsize + vsize`` samples;
each block of ``vsize`` input samples is written at the ring pointer, then
every output sample is the dot product of the IR against the delay line read
oldest -> newest with reversed coefficients (``cl_dconv.cpp:32-43``). The
time-varying step streams the second operand into the coefficient ring with
the same ring arithmetic (``cl_dconv.cpp:134-148``).

The per-block steps are plain PyTorch. ``dconv_stream`` sends every block of
a call through the whole-scan kernel (``ops/cuda/dstream.py``), for any
irsize and vsize, in float32; a float64 config (the reference's USE_DOUBLE
build) runs the per-block steps in float64, as the JAX package does. State
keeps the JAX package's field layout (``wp`` is a Python int), so a stream
can cross packages (see ``interop.py``). Functions return new state and do
not modify the state they are given.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import torch

from .cuda.dstream import context_blocks, dstream_steps


@dataclasses.dataclass(frozen=True)
class DconvConfig:
    """Static configuration (ctor args of Cldconv, cl_dconv.cpp:46-51).

    delay_compat: the reference kernel reads del[(wp+n+h) % end] with
    h <= irsize-1 after wp has advanced past the new block
    (cl_dconv.cpp:41,124-125), so output sample n never sees its own-time
    input: the result is sum_k coefs[k] * x[n-1-k], one sample later than
    a standard FIR. Default False computes the standard alignment
    (== np.convolve); True reproduces the reference's extra sample of delay.
    dtype: "f32" or "f64" (the reference's USE_DOUBLE build,
    macos-build.sh:5); only float32 reaches the kernel
    (``_kernel_eligible``).
    """

    irsize: int
    vsize: int
    delay_compat: bool = False
    dtype: str = "f32"

    def __post_init__(self):
        if self.irsize < 1 or self.vsize < 1:
            raise ValueError("irsize and vsize must be positive")
        if self.dtype not in ("f32", "f64"):
            raise ValueError(f"dtype must be 'f32'|'f64', got {self.dtype}")

    @property
    def compute_dtype(self) -> torch.dtype:
        """The dtype of the delay line, the coefficients and the outputs."""
        return torch.float64 if self.dtype == "f64" else torch.float32

    def _kernel_eligible(self) -> bool:
        """Whether ``dconv_stream`` takes the kernel: float32 only (JAX
        ``dconv.py:64``)."""
        return self.dtype == "f32"

    @property
    def ring(self) -> int:
        return self.irsize + self.vsize

    @property
    def off(self) -> int:
        """Offset of output sample 0 in the valid correlation: 1 for the
        standard alignment, 0 for the reference's (delay_compat)."""
        return 0 if self.delay_compat else 1


class DconvState(NamedTuple):
    """Ring state (cl_dconv.h:18-19), in the JAX package's field layout.

    ``coefs`` has ring length like the reference's coefficient buffer
    (cl_dconv.cpp:90-91) so the time-varying write pattern is identical;
    the LTI path only ever reads the first irsize entries.
    """

    delay: torch.Tensor   # (irsize + vsize,)
    coefs: torch.Tensor   # (irsize + vsize,)
    wp: int               # ring pointer


def dconv_init(cfg: DconvConfig, device: Union[str, torch.device]) -> DconvState:
    """Zero state on ``device`` in the config's dtype, wp = 0."""
    z = torch.zeros((cfg.ring,), dtype=cfg.compute_dtype, device=device)
    return DconvState(delay=z, coefs=z.clone(), wp=0)


def push_ir(cfg: DconvConfig, state: DconvState, ir: torch.Tensor) -> DconvState:
    """Load coefficients (Cldconv::push_ir, cl_dconv.cpp:150-153)."""
    if tuple(ir.shape) != (cfg.irsize,):
        raise ValueError(f"IR must have shape ({cfg.irsize},), got {tuple(ir.shape)}")
    coefs = state.coefs.clone()
    coefs[:cfg.irsize] = ir.to(coefs.dtype)
    return state._replace(coefs=coefs)


def _ring_write(ring: torch.Tensor, block: torch.Tensor, wp: int) -> torch.Tensor:
    """Write ``block`` at ring position wp, wrapping past the end (the
    two-segment write of cl_dconv.cpp:112-122, with correct counts)."""
    idx = (wp + torch.arange(block.shape[-1], device=ring.device)) % ring.shape[-1]
    ring = ring.clone()
    ring[idx] = block.to(ring.dtype)
    return ring


def dconv_step(cfg: DconvConfig, state: DconvState, block: torch.Tensor
               ) -> Tuple[DconvState, torch.Tensor]:
    """One LTI block: Cldconv::convolution(out, in) parity
    (cl_dconv.cpp:109-132). block: (vsize,) -> out: (vsize,).

    out[n] = sum_h d[n + off + h] * k[h]: the delay line rotated to read
    oldest -> newest (d[j] = delay[(wp + j) % ring], wp advanced past the
    new block) against the time-reversed coefficients k.
    """
    delay = _ring_write(state.delay, block, state.wp)
    wp = (state.wp + cfg.vsize) % cfg.ring            # cl_dconv.cpp:124
    d = torch.roll(delay, -wp)
    k = torch.flip(state.coefs[:cfg.irsize], (0,))
    valid = d.unfold(0, cfg.irsize, 1) @ k            # (vsize + 1,)
    out = valid[cfg.off:cfg.off + cfg.vsize]
    return state._replace(delay=delay, wp=wp), out


def dconv_step_tv(cfg: DconvConfig, state: DconvState, block_x: torch.Tensor,
                  block_h: torch.Tensor) -> Tuple[DconvState, torch.Tensor]:
    """One time-varying block: Cldconv::convolution(out, in1, in2) parity
    (cl_dconv.cpp:134-148): the second operand streams into the coefficient
    ring at the same pointer/wrap positions as the delay line, then the LTI
    step runs."""
    coefs = _ring_write(state.coefs, block_h, state.wp)
    return dconv_step(cfg, state._replace(coefs=coefs), block_x)


def dconv_stream(cfg: DconvConfig, state: DconvState, blocks: torch.Tensor
                 ) -> Tuple[DconvState, torch.Tensor]:
    """Run many LTI blocks, blocks: (nblocks, vsize) -> outs (nblocks, vsize).

    Every block goes through the whole-scan kernel (``ops/cuda/dstream.py``):
    its CUDA kernel (a direct FIR on the coefficients) for a CUDA tensor,
    its plain twin for a CPU tensor, for any irsize and vsize. The context of the first block is the ring's last
    irsize samples, front-padded with zeros to P = ceil(irsize / vsize)
    blocks and laid end to end with the blocks in one sequence; the ring
    afterwards is the tail of that sequence (exactly the last irsize + vsize
    samples). Same results as dconv_step per block. A float64 config runs
    ``dconv_step`` block by block (the JAX package's scan).
    """
    v = cfg.vsize
    if blocks.dim() != 2 or blocks.shape[1] != v:
        raise ValueError(f"blocks must be (nblocks, {v}), got {tuple(blocks.shape)}")
    if cfg._kernel_eligible() and blocks.is_cuda and blocks.dtype != torch.float32:
        raise TypeError(f"CUDA blocks must be float32, got {blocks.dtype}")
    nb = blocks.shape[0]
    if nb == 0:
        return state, blocks.new_zeros((0, v), dtype=cfg.compute_dtype)
    if not cfg._kernel_eligible():
        outs = []
        for blk in blocks:
            state, out = dconv_step(cfg, state, blk)
            outs.append(out)
        return state, torch.stack(outs)
    p = context_blocks(cfg.irsize, v)
    # rotated ring, oldest -> newest; its last irsize samples are the
    # context, front-padded to P blocks and followed by the new blocks
    ctx = torch.roll(state.delay, -state.wp)[v:]
    seq = torch.cat([ctx.new_zeros(p * v - cfg.irsize), ctx,
                     blocks.to(torch.float32).reshape(-1)])
    outs = dstream_steps(seq.reshape(p + nb, v), state.coefs[:cfg.irsize], v, cfg.off)
    wp_out = (state.wp + nb * v) % cfg.ring
    return state._replace(delay=torch.roll(seq[-cfg.ring:], wp_out), wp=wp_out), outs


def convolve_direct(signal, ir, vsize: int = 64,
                    device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """Full linear convolution via the streaming direct engine:
    len(signal) + len(ir) - 1 samples, matching np.convolve.

    ``device``: where to run; defaults to the device of ``signal`` when it
    is a tensor (a numpy signal needs an explicit device).
    """
    if device is None:
        if not isinstance(signal, torch.Tensor):
            raise ValueError("convolve_direct: pass device= for a non-tensor signal")
        device = signal.device
    signal = torch.as_tensor(signal, dtype=torch.float32, device=device)
    ir = torch.as_tensor(ir, dtype=torch.float32, device=device)
    cfg = DconvConfig(irsize=ir.shape[-1], vsize=vsize)
    out_len = signal.shape[-1] + ir.shape[-1] - 1
    nblocks = -(-out_len // vsize)
    sig_p = torch.nn.functional.pad(signal, (0, nblocks * vsize - signal.shape[-1]))
    state = push_ir(cfg, dconv_init(cfg, device), ir)
    _, out = dconv_stream(cfg, state, sig_p.reshape(nblocks, vsize))
    return out.reshape(-1)[:out_len]
