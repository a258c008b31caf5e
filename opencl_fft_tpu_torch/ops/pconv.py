"""Uniform partitioned fast convolution (frequency-delay line), LTI and
time-varying.

Counterpart of ``opencl_fft_tpu/ops/pconv.py`` (parity with ``Clpconv``,
``cl_conv.h:124-188``): a length-``cvs`` convolution split into
``nparts = cvs/pts`` spectral partitions with one-partition latency.

Normalization follows the reference: unnormalized transforms both ways and
one division by ``pts`` in the overlap-add. ``bin0_mode="exact"`` restores
the factor 2 that the packed (DC/2, Nyq/2) bin loses in the componentwise
product; ``"compat"`` reproduces the reference artifact.

State keeps the JAX package's field layout so that a stream can cross
packages (see ``interop.py``): a doubled input ring, an IR ring stored
reversed, the overlap-add tail and the two ring pointers. Functions return
new state and do not modify the state they are given.

Time-varying (TV) convolution streams the second operand into the IR ring:
each block's coefficient frame is written at slot wp2, which then
decrements (cl_conv.cpp:460-548).

The per-block functions (``pconv_step{,_tv}`` and the crossfade's
``pconv_begin_xfade`` / ``pconv_step_xfade``) launch the block-step kernels
of ``ops/cuda/blockstep.py`` and ``ops/cuda/mac.py`` on a state on a card
(``_block_kernels``), and above pts 2048 the MAC-and-unpack kernel
``block_mac_unpack`` before the inverse FFT (``_mac_unpack_kernel``); on
the CPU they keep the plain composition, which ``pconv_chunk{,_tv}``
reproduce bit for bit. An engine that owns its state runs the route above
pts 2048 as one replayed CUDA graph instead (``StepGraph``: the same
arithmetic over rings written in place, ring pointers read from device
memory). A crossfade replaces the IR
of a live stream without a click: both coefficient rings are kept and the
two exact convolutions are blended sample by sample (``XfadeState``);
``pconv_begin_xfade_planes`` begins one from coefficient planes already
analysed (``ir_planes``, ``push_ir``'s analysis).

The streams (``pconv_stream{,_tv}``, ``pconv_stream_batched{,_tv}``,
``convolve``) send every block through one whole-scan kernel launch
(``csrc/streamstep.cu``, in-kernel FFTs at every pts) through the
wrappers ``stream_steps_fused_batched{,_tv}`` of ``ops/cuda/streamstep.py``;
the single-channel streams are the C = 1 view of the batched ones.

Batched serving (``models/convolver.py``) runs C channels in lockstep on a
state whose planes have a leading channel axis (``models.batched_state``):
the per-block functions broadcast over it with shared int ring pointers
(the JAX package vmaps them; the block-step kernels take the channel as a
grid dimension), and ``pconv_stream_batched{,_tv}`` send every block of
every channel through one batched whole-scan kernel launch, with ring
pointers shared or one per channel. ``MatrixConvolver.stream`` runs
``_stream_scan`` with the matrix entry ``stream_steps_fused_matrix`` on a
state of one input ring an input and one tail an output.

When several blocks are known at once the frequency-delay-line MAC is a
sliding correlation over the frame timeline (the previous nparts-1 frames,
then the new ones): ``pconv_chunk{,_tv}`` take K <= nparts blocks a call,
bit-equal to per-block steps on the CPU; ``pconv_offline`` and ``_offline_batched``
(``Convolver.render``) render any number of blocks with one sliding-MAC
kernel launch (``ops/cuda/slidemac.py``), and
``pconv_stream_batched_chunked`` runs K-block chunks through them.
All of these and ``ops/decomposed.py`` (``stream_decomposed``, LTI and TV,
and ``stream_batched_tv_decomposed``, which ``pconv_stream_batched_tv_chunked``
runs in K-block chunks) share one engine, ``_timeline_engine``, and differ in
the MAC they give it; the TV paths give it their coefficient frames too.
``convolve_oneshot`` is one zero-padded transform pair.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..utils import profiling
from ..utils.numerics import exact_matmul, is_pow2
from .cplx import Cplx
from .cuda.blockstep import (block_mac_unpack, block_step_fused, block_step_fwd_fused,
                              block_step_fwd_fused_tv)
from .cuda.mac import spectral_mac
from .cuda.streamstep import Pointers, stream_steps_fused_batched, stream_steps_fused_batched_tv
from .cuda.slidemac import CHUNKMAC_MAX_BATCH, chunk_mac, macflow_lti_batched, slide_mac_plain
from .cuda.tables import fwd_table
from .fft import _IMPLS, fft_split
from .rfft import interleave, irfft_split, rfft_split

# Largest partition size whose dense forward table, (pts, 2*pts), the engine
# builds for ``_forward_partition``. Up to it the forward transform there is
# one product against the table and a state on a card runs the per-block
# step kernels (``_block_kernels``); above it the forward transform is the
# transform chain and the per-block functions run it around the
# MAC-and-unpack kernel (``_mac_unpack_kernel``). Every step kernel computes
# its transforms by FFTs at any pts, so above 2048 the split is a routing
# rule kept from the JAX package, not a table limit; the streams run one
# scan route at every pts.
_FWD_MM_MAX_PTS = 2048


@dataclasses.dataclass(frozen=True)
class PconvConfig:
    """Static configuration (the ctor args of Clpconv, cl_conv.cpp:140-143).

    pts:    partition size in samples (FFT size is 2*pts; bins = pts).
    nparts: number of partitions (= cvs / pts).
    bin0_mode: "exact" (true convolution) or "compat" (reference artifact).
    impl:   FFT implementation (see ops/fft.py).
    ring_dtype: storage of the spectral rings, "f32" or "bf16" (half the
            ring bytes at ~1e-3 relative output error; products still
            accumulate in the compute dtype).
    dtype:  compute width, "f32" or "f64" (the reference's USE_DOUBLE
            build, macos-build.sh:5).

    Only float32 compute on float32 rings reaches the hand-written kernels
    (``_kernel_eligible``, the JAX package's rule): any other config takes
    the plain composition on the device its state lives on, decided from
    the config before anything launches.
    """

    pts: int
    nparts: int
    bin0_mode: str = "exact"
    impl: str = "auto"
    ring_dtype: str = "f32"
    dtype: str = "f32"

    def __post_init__(self):
        if not is_pow2(self.pts) or self.pts < 2:
            raise ValueError(f"partition size must be a power of two >= 2, got {self.pts}")
        if self.nparts < 1:
            raise ValueError(f"need at least one partition, got {self.nparts}")
        if self.bin0_mode not in ("exact", "compat"):
            raise ValueError(f"bin0_mode must be 'exact' or 'compat', got {self.bin0_mode}")
        if self.impl not in _IMPLS:
            raise ValueError(f"unknown impl {self.impl!r}, expected one of {_IMPLS}")
        if self.ring_dtype not in ("f32", "bf16"):
            raise ValueError(f"ring_dtype must be 'f32'|'bf16', got {self.ring_dtype}")
        if self.dtype not in ("f32", "f64"):
            raise ValueError(f"dtype must be 'f32'|'f64', got {self.dtype}")
        if self.dtype == "f64" and self.ring_dtype != "f32":
            raise ValueError("f64 compute cannot use a reduced-width ring")

    @property
    def compute_dtype(self) -> torch.dtype:
        """The dtype of the transforms, the MAC and the overlap-add tail."""
        return torch.float64 if self.dtype == "f64" else torch.float32

    @property
    def storage_dtype(self) -> torch.dtype:
        """The dtype of the spectral rings."""
        return torch.bfloat16 if self.ring_dtype == "bf16" else self.compute_dtype

    def _kernel_eligible(self) -> bool:
        """Whether the hand-written kernels take this config: float32
        compute on float32 rings."""
        return self.ring_dtype == "f32" and self.dtype == "f32"

    @property
    def bins(self) -> int:
        return self.pts

    @property
    def cvs(self) -> int:
        return self.pts * self.nparts

    @property
    def b0_scale(self) -> float:
        return 2.0 if self.bin0_mode == "exact" else 1.0

    @staticmethod
    def for_ir_length(cvs: int, pts: int, **kw) -> "PconvConfig":
        """Reference ctor arithmetic: nparts = cvs / pts (cl_conv.cpp:143)."""
        if pts <= 0 or cvs % pts:
            raise ValueError(f"convolution size {cvs} must be a multiple of pts {pts}")
        return PconvConfig(pts=pts, nparts=cvs // pts, **kw)


_PLANES = ("spec_x_re", "spec_x_im", "spec_h_re", "spec_h_im", "tail")


class PconvState(NamedTuple):
    """Streaming state, in the JAX package's field layout.

    The input ring is stored DOUBLED (2*nparts rows; each frame written at
    wp and wp+nparts), so the MAC window is one contiguous row slice.
    The ring pointers are Python ints (no device sync to read them). A
    batched state gives every plane a leading channel axis (C, ...); its
    pointers are ints shared by every channel, or for the batched streams
    length-C tuples of ints, one per channel.
    """

    spec_x_re: torch.Tensor  # ([C,] 2*nparts, bins) doubled input spectral ring
    spec_x_im: torch.Tensor
    spec_h_re: torch.Tensor  # ([C,] nparts, bins) IR spectra, stored reversed
    spec_h_im: torch.Tensor
    tail: torch.Tensor       # ([C,] pts) overlap-add tail (unnormalized)
    wp: Pointers             # input ring pointer (increments)
    wp2: Pointers            # coefficient ring pointer (decrements)


def pconv_init(cfg: PconvConfig, device: Union[str, torch.device]) -> PconvState:
    """Zero state on ``device``; wp = 0, wp2 = nparts - 1 (cl_conv.cpp:144).
    The rings are in the config's storage dtype, the tail in its compute
    dtype."""
    def z(*shape, dtype=cfg.storage_dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return PconvState(
        spec_x_re=z(2 * cfg.nparts, cfg.bins), spec_x_im=z(2 * cfg.nparts, cfg.bins),
        spec_h_re=z(cfg.nparts, cfg.bins), spec_h_im=z(cfg.nparts, cfg.bins),
        tail=z(cfg.pts, dtype=cfg.compute_dtype), wp=0, wp2=cfg.nparts - 1)


def _widen(cfg: PconvConfig, *planes: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Ring planes in the compute dtype (the same tensors for float32
    rings)."""
    return tuple(p.to(cfg.compute_dtype) for p in planes)


def _frames(cfg: PconvConfig, blocks: torch.Tensor) -> Cplx:
    """``_forward_partition`` of blocks rounded through the ring's storage
    dtype first, then widened: the values a per-block step reads back from
    its ring, so a chunk's MAC sees what sequential steps see (JAX
    ``pconv.py:580-584``; a no-op for rings in the compute dtype)."""
    fr, fi = _forward_partition(cfg, blocks)
    return _widen(cfg, fr.to(cfg.storage_dtype), fi.to(cfg.storage_dtype))


def _forward_partition(cfg: PconvConfig, block: torch.Tensor) -> Cplx:
    """Zero-padded unnormalized forward real FFT of (..., pts) blocks.

    For float32 compute up to _FWD_MM_MAX_PTS the whole chain (zero-pad ->
    deinterleave -> half-size DFT -> pack) is one matmul against the
    f64-built (pts, 2*bins) table, as in the JAX package; beyond, and for
    float64 compute (in float64), the transform chain.
    On the CPU the matmul is a 2-D product of at least two rows: a one-row
    product takes BLAS's matrix-vector route, which rounds differently, and
    a block's frame must not depend on how many blocks share the product
    (``pconv_chunk`` is bit-equal to sequential ``pconv_step`` calls there).
    cuBLAS keeps no such promise between row counts, so on a card the
    product runs as given.
    """
    block = block.to(cfg.compute_dtype)
    if cfg.pts <= _FWD_MM_MAX_PTS and block.dtype == torch.float32:
        rows = block.reshape(-1, cfg.pts)
        if rows.shape[0] == 1 and rows.device.type == "cpu":
            rows = torch.cat([rows, torch.zeros_like(rows)])
        z = exact_matmul(rows, fwd_table(cfg.pts, block.device, torch.float64)
                         )[:block.numel() // cfg.pts]
        z = z.reshape(block.shape[:-1] + (2 * cfg.bins,))
        return z[..., :cfg.bins], z[..., cfg.bins:]
    frame = torch.cat([block, torch.zeros_like(block)], dim=-1)
    return rfft_split(frame, cfg.impl, unnormalized=True)


def push_ir(cfg: PconvConfig, state: PconvState, ir: torch.Tensor) -> PconvState:
    """Analyze an impulse response into the coefficient ring: ir (cvs,),
    or (C, cvs) for a batched state.

    Parity with Clpconv::push_ir (cl_conv.cpp:353-388): partition j is
    written at slot wp2 - j, so the ring holds the partitions in REVERSE
    order and wp2 ends where it started.
    """
    shape = tuple(state.spec_h_re.shape[:-2]) + (cfg.cvs,)
    if tuple(ir.shape) != shape:
        raise ValueError(f"IR must have shape {shape}, got {tuple(ir.shape)}")
    spec_h_re, spec_h_im = ir_planes(cfg, ir, state.wp2)
    return state._replace(spec_h_re=spec_h_re, spec_h_im=spec_h_im)


def ir_planes(cfg: PconvConfig, ir: torch.Tensor, wp2: int) -> Cplx:
    """The coefficient planes of (..., cvs) impulse responses, (...,
    nparts, bins) each in the ring's storage dtype, in the ring's slot
    order for the coefficient pointer ``wp2``: partition j at slot
    wp2 - j (``push_ir``'s analysis, without a state)."""
    hr, hi = _forward_partition(cfg, ir.reshape(ir.shape[:-1] + (cfg.nparts, cfg.pts)))
    slots = (wp2 - torch.arange(cfg.nparts, device=ir.device)) % cfg.nparts
    # the map j -> (wp2 - j) mod nparts is its own inverse: gathering
    # partition slots[s] into slot s puts partition j at slot wp2 - j
    return hr[..., slots, :].to(cfg.storage_dtype), hi[..., slots, :].to(cfg.storage_dtype)


def _block_kernels(cfg: PconvConfig, device: torch.device) -> bool:
    """Whether the per-block functions launch the block-step kernels: for a
    state on a CUDA card at pts <= _FWD_MM_MAX_PTS, the JAX package's
    routing (the kernels transform by in-kernel FFTs and take pts up to
    2^14; above 2048 the per-block functions keep ``block_mac_unpack``'s
    route, ``_mac_unpack_kernel``). Any state on the CPU takes the plain
    composition (forward product or transform chain, MAC, inverse
    transform), as does a config the kernels do not take
    (``_kernel_eligible``). A routing rule: nothing falls back on a
    failure."""
    return (cfg._kernel_eligible() and torch.device(device).type == "cuda"
            and cfg.pts <= _FWD_MM_MAX_PTS)


def _mac_unpack_kernel(cfg: PconvConfig, device: torch.device) -> bool:
    """Whether the per-block functions run their MAC and inverse through
    ``_mac_unpack_inverse_ola`` (the ``block_mac_unpack`` kernel, then the
    inverse FFT): for a state on a CUDA card at pts > _FWD_MM_MAX_PTS, the
    complement of ``_block_kernels`` among the configs the kernels take. A
    routing rule, like it."""
    return (cfg._kernel_eligible() and torch.device(device).type == "cuda"
            and cfg.pts > _FWD_MM_MAX_PTS)


def _rings(state: PconvState) -> Tuple[Cplx, Cplx]:
    """The doubled input ring and the coefficient ring, split."""
    return (state.spec_x_re, state.spec_x_im), (state.spec_h_re, state.spec_h_im)


def _shared(p: Pointers) -> int:
    """A ring pointer shared by every channel; the per-block steps take no
    per-channel pointers."""
    if not isinstance(p, int):
        raise ValueError(f"the per-block steps need ring pointers shared by every "
                         f"channel (ints), got {p!r}")
    return p


def _spectral_mac(cfg: PconvConfig, state: PconvState, rp: int) -> Cplx:
    """Frequency-delay-line MAC: sum over partitions of in[(rp+q) % np] *
    coef[q]; bin 0 (the packed (DC, Nyq) pair) multiplies componentwise
    (cl_conv_kernels.h:102-118). On a card (``_block_kernels``) the
    ``spectral_mac`` kernel; else the rings widened to the compute dtype
    (JAX ``pconv.py:361-368``)."""
    if _block_kernels(cfg, state.tail.device):
        return spectral_mac(*_rings(state), _shared(rp), cfg.b0_scale)
    return _window_mac(cfg, *_widen(cfg, state.spec_x_re[..., rp:rp + cfg.nparts, :],
                                    state.spec_x_im[..., rp:rp + cfg.nparts, :],
                                    state.spec_h_re, state.spec_h_im))


def _window_mac(cfg: PconvConfig, xr: torch.Tensor, xi: torch.Tensor,
                hr: torch.Tensor, hi: torch.Tensor) -> Cplx:
    """The MAC of ``_spectral_mac`` on (..., nparts, bins) windows and
    coefficient planes (broadcast over leading axes), summed over the
    partition axis."""
    acc_r = torch.sum(xr * hr - xi * hi, dim=-2)
    acc_i = torch.sum(xr * hi + xi * hr, dim=-2)
    acc_r[..., 0] = cfg.b0_scale * torch.sum(xr[..., 0] * hr[..., 0], dim=-1)
    acc_i[..., 0] = cfg.b0_scale * torch.sum(xi[..., 0] * hi[..., 0], dim=-1)
    return acc_r, acc_i


def _inverse_and_ola(cfg: PconvConfig, state: PconvState, acc: Cplx
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse transform + overlap-add; returns (out_block, new_tail):
    out = (first half + tail) / pts, new tail = second half
    (cl_conv_kernels.h:120-124). The tail is contiguous: a batched state's
    planes chain into the whole-scan kernels, which take no others."""
    return _ola(cfg, state, irfft_split(acc, cfg.impl))


def _ola(cfg: PconvConfig, state: PconvState, y: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Overlap-add of an inverse transform y (..., 2*pts): (out_block,
    new_tail), out = (first half + tail) / pts, new tail = second half,
    contiguous."""
    return (y[..., :cfg.pts] + state.tail) / cfg.pts, y[..., cfg.pts:].contiguous()


def _mac_unpack_inverse_ola(cfg: PconvConfig, state: PconvState, rp: int,
                            rp_at: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_inverse_and_ola`` of the MAC at rp with the MAC and the inverse
    unpack in one ``block_mac_unpack`` launch (its twin for CPU tensors),
    then the half-size inverse FFT (``fft_vmem`` on a card at 2^10..2^20
    bins), the interleave and the overlap-add; the tail is contiguous.
    ``rp_at``: rp in device memory, read when the kernel runs
    (``StepGraph``)."""
    z = block_mac_unpack(*_rings(state), _shared(rp), cfg.b0_scale, rp_at)
    return _ola(cfg, state, interleave(fft_split(z, +1, cfg.impl)))


def _mac_inverse_ola(cfg: PconvConfig, state: PconvState, rp: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MAC at rp, inverse transform and overlap-add: (out_block, new_tail).
    On a card one ``block_step_fused`` launch (``_block_kernels``) or, above
    pts 2048, ``_mac_unpack_inverse_ola`` (``_mac_unpack_kernel``); else
    ``_spectral_mac`` then ``_inverse_and_ola``."""
    if _block_kernels(cfg, state.tail.device):
        return block_step_fused(*_rings(state), _shared(rp), cfg.b0_scale, state.tail,
                                cfg.pts)
    if _mac_unpack_kernel(cfg, state.tail.device):
        return _mac_unpack_inverse_ola(cfg, state, rp)
    return _inverse_and_ola(cfg, state, _spectral_mac(cfg, state, rp))


def _ring_write2(ring: torch.Tensor, row: torch.Tensor, wp: int,
                 nparts: int) -> torch.Tensor:
    """Write one frame into the doubled ring: at wp and wp + nparts, in
    the ring's dtype."""
    row = row.to(ring.dtype)
    ring = ring.clone()
    profiling.add("step.ring_clone_bytes", ring.nbytes)
    ring[..., wp, :] = row
    ring[..., wp + nparts, :] = row
    return ring


def _step_fused(cfg: PconvConfig, state: PconvState, block: torch.Tensor
                ) -> Tuple[PconvState, torch.Tensor]:
    """``pconv_step`` as one ``block_step_fwd_fused`` launch (its twin for
    CPU tensors): forward product, ring write, MAC, post product and OLA."""
    rp = (_shared(state.wp) + 1) % cfg.nparts
    out, tail, (xr, xi) = block_step_fwd_fused(
        block.to(torch.float32).contiguous(), *_rings(state), rp, cfg.b0_scale, state.tail,
        cfg.pts)
    return state._replace(spec_x_re=xr, spec_x_im=xi, wp=rp, tail=tail), out


def _step_tv_fused(cfg: PconvConfig, state: PconvState, block_x: torch.Tensor,
                   block_h: torch.Tensor) -> Tuple[PconvState, torch.Tensor]:
    """``pconv_step_tv`` as one ``block_step_fwd_fused_tv`` launch (its twin
    for CPU tensors)."""
    rp = (_shared(state.wp) + 1) % cfg.nparts
    wp2 = _shared(state.wp2)
    both = torch.stack([block_x.to(torch.float32), block_h.to(torch.float32)])
    out, tail, (xr, xi), (hr, hi) = block_step_fwd_fused_tv(
        both, *_rings(state), rp, wp2, cfg.b0_scale, state.tail, cfg.pts)
    return state._replace(spec_x_re=xr, spec_x_im=xi, spec_h_re=hr, spec_h_im=hi, wp=rp,
                          wp2=(wp2 - 1) % cfg.nparts, tail=tail), out


def pconv_step(cfg: PconvConfig, state: PconvState, block: torch.Tensor
               ) -> Tuple[PconvState, torch.Tensor]:
    """One LTI streaming block: Clpconv::convolution(out, in) parity
    (cl_conv.cpp:393-458). block: (pts,) -> out: (pts,); with a batched
    state, (C, pts) -> (C, pts).

    On a card at pts <= _FWD_MM_MAX_PTS (``_block_kernels``) the whole
    block is one ``block_step_fwd_fused`` launch; above, the forward
    transform chain, the ring write and ``_mac_inverse_ola`` (one
    ``block_mac_unpack`` launch and the inverse FFT); on the CPU the plain
    composition, which ``pconv_chunk`` reproduces bit for bit. Traced as
    the span ``step`` (counters ``step.blocks``, ``step.ring_clone_bytes``)."""
    with profiling.span("step"):
        profiling.add("step.blocks")
        if _block_kernels(cfg, state.tail.device):
            return _step_fused(cfg, state, block)
        xr, xi = _forward_partition(cfg, block)
        wp = (state.wp + 1) % cfg.nparts                  # cl_conv.cpp:424
        state = state._replace(
            spec_x_re=_ring_write2(state.spec_x_re, xr, state.wp, cfg.nparts),
            spec_x_im=_ring_write2(state.spec_x_im, xi, state.wp, cfg.nparts),
            wp=wp)
        out, tail = _mac_inverse_ola(cfg, state, wp)
        return state._replace(tail=tail), out


def pconv_step_tv(cfg: PconvConfig, state: PconvState, block_x: torch.Tensor,
                  block_h: torch.Tensor) -> Tuple[PconvState, torch.Tensor]:
    """One time-varying block: Clpconv::convolution(out, in1, in2) parity
    (cl_conv.cpp:460-548). Both operands go through one batched forward
    transform; the coefficient frame lands at slot wp2 (then wp2
    decrements) and takes part in this block's MAC. Blocks (pts,), or
    (C, pts) with a batched state. On a card at pts <= _FWD_MM_MAX_PTS one
    ``block_step_fwd_fused_tv`` launch, as ``pconv_step``; above, the
    coefficient frame is written before ``_mac_inverse_ola`` reads the ring
    (``block_mac_unpack``). Traced as ``pconv_step``."""
    with profiling.span("step"):
        profiling.add("step.blocks")
        if _block_kernels(cfg, state.tail.device):
            return _step_tv_fused(cfg, state, block_x, block_h)
        both = torch.stack([block_x.to(cfg.compute_dtype), block_h.to(cfg.compute_dtype)])
        fr, fi = _forward_partition(cfg, both)            # (2, [C,] bins)
        spec_h_re = state.spec_h_re.clone()
        spec_h_im = state.spec_h_im.clone()
        profiling.add("step.ring_clone_bytes", spec_h_re.nbytes + spec_h_im.nbytes)
        spec_h_re[..., state.wp2, :] = fr[1].to(spec_h_re.dtype)
        spec_h_im[..., state.wp2, :] = fi[1].to(spec_h_im.dtype)
        wp = (state.wp + 1) % cfg.nparts                  # cl_conv.cpp:516
        state = state._replace(
            spec_x_re=_ring_write2(state.spec_x_re, fr[0], state.wp, cfg.nparts),
            spec_x_im=_ring_write2(state.spec_x_im, fi[0], state.wp, cfg.nparts),
            spec_h_re=spec_h_re, spec_h_im=spec_h_im, wp=wp,
            wp2=(state.wp2 - 1) % cfg.nparts)             # cl_conv.cpp:519
        out, tail = _mac_inverse_ola(cfg, state, wp)
        return state._replace(tail=tail), out


def settle_failed_capture(stream: "torch.cuda.Stream") -> None:
    """After a CUDA graph capture on ``stream`` failed: take the card's
    default random generator out of its capture state. PyTorch raises from
    ``capture_end`` before the generator's epilogue, and every later random
    draw on the card would then raise; a capture that succeeds runs it."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        graph.capture_begin(capture_error_mode="thread_local")
        torch.zeros(1, device=stream.device)
        graph.capture_end()


class StepGraph:
    """The per-block step of one engine above pts 2048
    (``_mac_unpack_kernel``) as the replay of one captured CUDA graph, over
    ring planes that the graph owns and writes in place.

    An engine that owns its state (``api.Clpconv``, the zero-latency
    engine's terminal segment) hands ``step`` its state and keeps the state
    it returns (``published``): the same tensors at every firing,
    overwritten by the next, with the ring pointers as ints that the host
    advances as ``pconv_step{,_tv}`` do. A state other than the one it
    published last (the first, a ``push_ir``, a finished crossfade, a state
    set from outside) is copied into its planes first.

    The body is ``pconv_step`` (``tv``: ``pconv_step_tv``), in its order
    and without a clone: the input block(s) and the pointers (rp, wp, wp +
    nparts, wp2) copied in from pinned buffers (``x_np``, ``p_np``), the
    forward transform chain, the ring rows written at the pointers read
    from device memory, ``block_mac_unpack`` reading rp there, the inverse
    FFT and the overlap-add into the owned tail, the output copied into
    pinned memory (``output`` waits for it). A ``source`` (a device tensor
    whose address stays) stands in for the upload; a ``sink(out)``, enqueued
    in the body, for the output's copy.

    On a card the first firing runs the body eagerly, so the C entries'
    one-time set-up and the cached tables come before any capture; the
    second captures it, and every firing from then on replays it. Off a
    card the body runs eagerly at every firing (the CPU tests hold it
    bit-equal to ``pconv_step{,_tv}`` on their ``block_mac_unpack`` route).
    A capture that fails leaves the eager body for good, said once through
    ``on_message(msg)``.

    Each firing is the span ``step`` and counts ``step.blocks``, 0
    ``step.ring_clone_bytes`` and ``step.replays`` (1 for a replay).
    """

    def __init__(self, cfg: PconvConfig, device: Union[str, torch.device], tv: bool,
                 source: Optional[torch.Tensor] = None,
                 sink: Optional[Callable[[torch.Tensor], None]] = None,
                 on_message: Optional[Callable[[str], None]] = None):
        dev = torch.device(device)
        self.cfg, self.device, self.tv = cfg, dev, tv
        self.capture = pin = dev.type == "cuda"
        self.source, self.sink = source, sink
        self.on_message = on_message or (lambda msg: None)
        self.x_host = torch.zeros((2 if tv else 1, cfg.pts), dtype=torch.float32, pin_memory=pin)
        self.y_host = torch.zeros(cfg.pts, dtype=torch.float32, pin_memory=pin)
        self.p_host = torch.zeros(4, dtype=torch.int32, pin_memory=pin)
        self.x_np, self.y_np, self.p_np = self.x_host.numpy(), self.y_host.numpy(), \
            self.p_host.numpy()
        self.x_dev = torch.zeros(self.x_host.shape, dtype=torch.float32, device=dev)
        self.ptr = torch.zeros(4, dtype=torch.int32, device=dev)
        self.published: Optional[PconvState] = None
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.warm = self.capture            # an eager firing before the capture
        self.failed: Optional[str] = None
        self.done = torch.cuda.Event() if pin else None
        # the graph replays on the current stream of the current device
        self.on_device = torch.cuda.device(dev) if pin else contextlib.nullcontext()
        if self.capture:
            self.stream = torch.cuda.Stream(dev)

    def step(self, state: PconvState) -> PconvState:
        """Fire one block from ``state``; returns the state after it."""
        with profiling.span("step"), self.on_device:
            if state is not self.published:
                self._adopt(state)
            st, n = self.published, self.cfg.nparts
            rp = (st.wp + 1) % n
            self.p_np[:] = (rp, st.wp, st.wp + n, st.wp2)
            replayed = 0
            if self.graph is not None:
                self.graph.replay()
                replayed = 1
            elif self.capture and not self.warm and self.failed is None:
                replayed = self._capture(rp)
            else:
                self.warm = False
                self._body(rp)
            if self.done is not None:
                self.done.record()
            self.published = st._replace(wp=rp, wp2=(st.wp2 - 1) % n if self.tv else st.wp2)
            profiling.add("step.blocks")
            profiling.add("step.ring_clone_bytes", 0)
            profiling.add("step.replays", replayed)
        return self.published

    def output(self) -> np.ndarray:
        """The last firing's output block (pts,), once the device has
        written it: a view of the pinned buffer, valid until the next
        firing."""
        if self.done is not None:
            self.done.synchronize()
        return self.y_np

    def _adopt(self, state: PconvState) -> None:
        """Copy ``state``'s planes into the graph's own (allocated like them
        the first time) and take its pointers."""
        given = [getattr(state, k) for k in _PLANES]
        if self.published is None:
            mine = [torch.empty_like(p, memory_format=torch.contiguous_format) for p in given]
        else:
            mine = [getattr(self.published, k) for k in _PLANES]
        for m, g in zip(mine, given):
            if (m.shape, m.dtype, m.device) != (g.shape, g.dtype, g.device):
                raise ValueError(f"a step graph takes states of its own shapes, got "
                                 f"{tuple(g.shape)} {g.dtype} for {tuple(m.shape)} {m.dtype}")
            if m is not g:
                m.copy_(g)
        self.published = PconvState(*mine, wp=_shared(state.wp), wp2=_shared(state.wp2))

    def _body(self, rp: int) -> None:
        """One firing on the published planes, in place; rp the host's value
        of the pointer that the MAC reads from device memory."""
        cfg, st = self.cfg, self.published
        self.ptr.copy_(self.p_host, non_blocking=True)
        if self.source is None:
            self.x_dev.copy_(self.x_host, non_blocking=True)
            x = self.x_dev if self.tv else self.x_dev[0]
        else:
            x = self.source
        fr, fi = _forward_partition(cfg, x)
        rows = self.ptr.long()                                  # rp, wp, wp + nparts, wp2
        if self.tv:
            for ring, row in ((st.spec_h_re, fr[1]), (st.spec_h_im, fi[1])):
                ring.index_copy_(0, rows[3:], row.to(ring.dtype)[None])
            fr, fi = fr[0], fi[0]
        for ring, row in ((st.spec_x_re, fr), (st.spec_x_im, fi)):
            ring.index_copy_(0, rows[1:3], row.to(ring.dtype).expand(2, -1))
        out, tail = _mac_unpack_inverse_ola(cfg, st, rp, self.ptr[:1])
        st.tail.copy_(tail)
        if self.sink is None:
            self.y_host.copy_(out, non_blocking=True)
        else:
            self.sink(out)

    def _capture(self, rp: int) -> int:
        """Capture the body into the graph and replay it: 1. Where the
        capture fails, the body runs eagerly (now and from then on): 0."""
        here = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(here)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(self.stream):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self._body(rp)
                finally:
                    graph.capture_end()
        except RuntimeError as e:
            self.failed = f"capture failed: {e}"
            settle_failed_capture(self.stream)
            self.on_message(f"per-block step graph off: {self.failed}")
            here.wait_stream(self.stream)
            self._body(rp)
            return 0
        here.wait_stream(self.stream)
        self.graph = graph
        graph.replay()
        return 1


class XfadeState(NamedTuple):
    """An IR replacement in progress (``pconv_begin_xfade``), in the JAX
    package's field layout.

    ``state`` carries the shared input ring, the INCOMING IR's coefficient
    ring and the incoming path's overlap-add tail; the outgoing IR's
    coefficient ring and tail ride alongside until the fade ends. A batched
    state gives every plane a leading channel axis.
    """

    state: PconvState
    old_h_re: torch.Tensor   # ([C,] nparts, bins) outgoing coefficient ring
    old_h_im: torch.Tensor
    old_tail: torch.Tensor   # ([C,] pts) outgoing path's overlap-add tail


def pconv_begin_xfade(cfg: PconvConfig, state: PconvState, new_ir: torch.Tensor
                      ) -> XfadeState:
    """Begin a crossfaded IR replacement on a live LTI stream (beyond the
    reference, whose push_ir swaps the ring at once, cl_conv.cpp:353-388:
    a click on a live stream). new_ir: (cvs,), or (C, cvs) for a batched
    state.

    The incoming path's tail is rebuilt exactly: the previous block's MAC
    (at the current wp, ``spectral_mac`` on a card; above pts 2048 the MAC
    and unpack of ``block_mac_unpack``) and inverse transform are run again
    against the new coefficients over the retained input ring, which holds
    the whole dependency window. From the first faded sample the output is
    (1-r)·conv(x, old_ir) + r·conv(x, new_ir) over the whole input history
    (``pconv.py:506-527``).
    """
    new_state = push_ir(cfg, state, new_ir)
    return pconv_begin_xfade_planes(cfg, state, new_state.spec_h_re, new_state.spec_h_im)


def pconv_begin_xfade_planes(cfg: PconvConfig, state: PconvState, h_re: torch.Tensor,
                             h_im: torch.Tensor) -> XfadeState:
    """``pconv_begin_xfade`` to coefficient planes already analysed (each
    ([C,] nparts, bins) in the ring's slot order for ``state.wp2``, as
    ``ir_planes`` gives them): no IR is transformed here. The incoming
    path's tail is rebuilt as there."""
    new_state = state._replace(spec_h_re=h_re, spec_h_im=h_im)
    if _block_kernels(cfg, state.tail.device):
        _, tail_new = _inverse_and_ola(cfg, new_state,
                                       _spectral_mac(cfg, new_state, _shared(state.wp)))
    else:
        _, tail_new = _mac_inverse_ola(cfg, new_state, _shared(state.wp))
    return XfadeState(state=new_state._replace(tail=tail_new), old_h_re=state.spec_h_re,
                      old_h_im=state.spec_h_im, old_tail=state.tail)


def pconv_step_xfade(cfg: PconvConfig, xf: XfadeState, block: torch.Tensor, ramp
                     ) -> Tuple[XfadeState, torch.Tensor]:
    """One LTI block during a crossfaded IR replacement: block ([C,] pts)
    -> out ([C,] pts) = out_old + ramp * (out_new - out_old).

    ``ramp``: (pts,) blend weights in [0, 1] for the incoming IR (0 = all
    outgoing). Both paths share one forward transform and one input-ring
    write, and each keeps its own tail, so both convolutions stay exact
    through the fade (``pconv.py:530-554``). The incoming path is
    ``pconv_step`` on ``xf.state`` (on a card one ``block_step_fwd_fused``
    launch, which writes the new ring), the outgoing one ``_mac_inverse_ola``
    over that ring with the old coefficients (one ``block_step_fused``
    launch): the two kernels share their MAC and post stages, so where the
    coefficients agree (a channel a batched fade leaves alone) the two paths,
    and so the blend, are bit-equal to a plain ``pconv_step``. Above pts
    2048 both paths run ``_mac_inverse_ola`` (one ``block_mac_unpack``
    launch each), with the same property. Once the ramp has reached 1,
    continue with ``xf.state``.
    """
    st, out_new = pconv_step(cfg, xf.state, block)
    st_old = st._replace(spec_h_re=xf.old_h_re, spec_h_im=xf.old_h_im, tail=xf.old_tail)
    out_old, tail_old = _mac_inverse_ola(cfg, st_old, st.wp)
    ramp = torch.as_tensor(ramp, dtype=out_new.dtype, device=out_new.device)
    return (xf._replace(state=st, old_tail=tail_old),
            out_old + ramp * (out_new - out_old))


def _xfade_ramp(cfg: PconvConfig, pos: int, fade_blocks: int,
                device: torch.device) -> torch.Tensor:
    """The blend weights of fade block ``pos`` of ``fade_blocks``: (pts,)
    float32 rising by 1/(fade_blocks*pts) a sample to exactly 1 at the last
    sample of the fade (the JAX classes' ramp, in the same float32
    arithmetic)."""
    ramp = (np.arange(cfg.pts, dtype=np.float32) + 1 + pos * cfg.pts) \
        / np.float32(fade_blocks * cfg.pts)
    return torch.from_numpy(ramp).to(device)


def _chunk_size(cfg: PconvConfig, state: PconvState, blocks: torch.Tensor,
                name: str = "blocks") -> int:
    """K of a chunk: blocks must be (K, [C,] pts) with 1 <= K <= nparts."""
    if tuple(blocks.shape[1:]) != tuple(state.tail.shape):
        raise ValueError(f"{name} must be (K, {', '.join(map(str, state.tail.shape))}), "
                         f"got {tuple(blocks.shape)}")
    k = blocks.shape[0]
    if not 1 <= k <= cfg.nparts:
        raise ValueError(f"chunk size must be in [1, nparts={cfg.nparts}], got {k}")
    return k


def _x_prefix_rows(cfg: PconvConfig, state: PconvState) -> Cplx:
    """The nparts-1 previous input frames in ascending time: one slice of
    the doubled ring, rows [wp+1, wp+nparts), ([C,] nparts-1, bins)."""
    if isinstance(state.wp, tuple):
        raise ValueError("this engine needs ring pointers shared by every channel "
                         "(ints), got per-channel pointers")
    rows = slice(state.wp + 1, state.wp + cfg.nparts)
    return state.spec_x_re[..., rows, :], state.spec_x_im[..., rows, :]


def _rings_after(cfg: PconvConfig, state: PconvState, fr: torch.Tensor,
                 fi: torch.Tensor) -> Cplx:
    """The doubled input rings after nb blocks whose frames are fr, fi
    ([C,] nb, bins), any nb, in the rings' storage dtype: below nparts
    frame t lands at slot (wp + t) mod nparts and its double; from nparts
    on slot s holds frame t_s = nb-1 - ((wp + nb-1 - s) mod nparts), the
    last to land there."""
    nb = fr.shape[-2]
    fr, fi = fr.to(cfg.storage_dtype), fi.to(cfg.storage_dtype)
    if nb < cfg.nparts:
        slots = (state.wp + torch.arange(nb, device=fr.device)) % cfg.nparts
        rings = []
        for ring, f in ((state.spec_x_re, fr), (state.spec_x_im, fi)):
            ring = ring.clone()
            profiling.add("step.ring_clone_bytes", ring.nbytes)
            ring[..., slots, :] = f
            ring[..., slots + cfg.nparts, :] = f
            rings.append(ring)
        return tuple(rings)
    s = torch.arange(cfg.nparts, device=fr.device)
    t_s = nb - 1 - ((state.wp + nb - 1 - s) % cfg.nparts)
    return tuple(torch.cat([f[..., t_s, :]] * 2, -2) for f in (fr, fi))


def _h_prefix_rows(cfg: PconvConfig, state: PconvState) -> Cplx:
    """The coefficient ring in the TV pairing's time order, ([C,] nparts-1,
    bins): row j holds the frame of pseudo-time f = j - (nparts-1) < 0,
    ring slot (wp2 - f) mod nparts; wp2 an int shared by every channel."""
    slots = (state.wp2 - torch.arange(-(cfg.nparts - 1), 0,
                                      device=state.spec_h_re.device)) % cfg.nparts
    return state.spec_h_re[..., slots, :], state.spec_h_im[..., slots, :]


def _timeline_engine(cfg: PconvConfig, state: PconvState, fr: torch.Tensor,
                     fi: torch.Tensor, mac: Callable[..., Cplx],
                     h_frames: Optional[Cplx] = None) -> Tuple[PconvState, torch.Tensor]:
    """The engine of every path whose blocks are known up front
    (``pconv_chunk{,_tv}``, ``_offline_batched``, ``ops/decomposed.py``).

    fr, fi ([C,] nb, bins) are the frames of nb new blocks (``_frames``:
    in the compute dtype, rounded through the ring's). They follow the
    nparts-1 previous frames of the ring, widened, in a timeline ([C,]
    nparts + nb, bins) whose last row is zero and feeds no output (``chunk_mac``'s
    layout; the macflow wrappers read its first nparts-1+nb rows).
    ``mac(timeline)`` gives the nb accumulators ([C,] nb, bins); one
    inverse transform and the overlap-add give outs ([C,] nb, pts), each
    block as ``_inverse_and_ola`` gives it. The state gets the rings after
    the nb frames, wp + nb and the last block's tail.

    With ``h_frames`` (the nb blocks' coefficient frames, the TV engine)
    the MAC is ``mac(timeline, h_timeline)``, the h timeline ([C,]
    nparts-1+nb, bins) being ``_h_prefix_rows`` then the new frames, and the
    state also gets the coefficient ring after the nb frames and wp2 - nb.
    """
    nb = fr.shape[-2]
    old_r, old_i = _widen(cfg, *_x_prefix_rows(cfg, state))
    pad = fr.new_zeros(fr.shape[:-2] + (1, cfg.bins))
    xtl = (torch.cat([old_r, fr, pad], -2), torch.cat([old_i, fi, pad], -2))
    if h_frames is None:
        acc = mac(xtl)
    else:
        htl = tuple(torch.cat([old, new], -2)
                    for old, new in zip(_widen(cfg, *_h_prefix_rows(cfg, state)), h_frames))
        acc = mac(xtl, htl)
    y = irfft_split(acc, cfg.impl)                    # ([C,] nb, 2*pts)
    tails = torch.cat([state.tail.unsqueeze(-2), y[..., :-1, cfg.pts:]], -2)
    sxr, sxi = _rings_after(cfg, state, fr, fi)
    new = state._replace(spec_x_re=sxr, spec_x_im=sxi, wp=(state.wp + nb) % cfg.nparts,
                         tail=y[..., -1, cfg.pts:].contiguous())
    if h_frames is not None:
        # slot q ends holding the last frame written there: that of block
        # t_q = nb-1 - ((nb-1 - wp2 + q) mod nparts), h timeline row
        # t_q + nparts-1 (t_q < 0 lands in the prefix rows, same formula)
        q = torch.arange(cfg.nparts, device=fr.device)
        rows = nb - 1 - (nb - 1 - state.wp2 + q) % cfg.nparts + cfg.nparts - 1
        new = new._replace(spec_h_re=htl[0][..., rows, :].to(cfg.storage_dtype),
                           spec_h_im=htl[1][..., rows, :].to(cfg.storage_dtype),
                           wp2=(state.wp2 - nb) % cfg.nparts)
    return new, (y[..., :cfg.pts] + tails) / cfg.pts


def _gather_mac(cfg: PconvConfig, hr: torch.Tensor, hi: torch.Tensor
                ) -> Callable[[Cplx], Cplx]:
    """The chunk paths' ``mac``: every block's window gathered from the
    timeline, ([C,] K, nparts, bins), and reduced against hr, hi
    (broadcast to it) as ``pconv_step`` reduces its ring window, so a chunk
    is bit-equal to sequential steps."""
    def mac(tl: Cplx) -> Cplx:
        k = tl[0].shape[-2] - cfg.nparts
        idx = (torch.arange(k, device=hr.device)[:, None]
               + torch.arange(cfg.nparts, device=hr.device))
        return _window_mac(cfg, tl[0][..., idx, :], tl[1][..., idx, :], hr, hi)
    return mac


def pconv_chunk(cfg: PconvConfig, state: PconvState, blocks: torch.Tensor
                ) -> Tuple[PconvState, torch.Tensor]:
    """K consecutive LTI blocks in one call, 1 <= K <= nparts: blocks (K,
    pts) -> outs (K, pts); with a batched state (K, C, pts) -> (K, C, pts).

    Bit-equal to K sequential ``pconv_step`` calls on the CPU (the JAX
    package's contract, ``pconv.py:557-632``), with one forward product and
    one inverse transform for the K blocks: the sequential MAC is a sliding
    complex dot of the coefficient frames against the frame timeline (the
    nparts-1 previous frames from the ring, then the K new ones), and
    every block's window is gathered from it and reduced as the step
    reduces its ring window. Latency becomes K blocks. Plain PyTorch on
    either device (the JAX package has no kernel for it). With bf16 rings
    the fresh frames are rounded through bf16 before the MAC, as the steps
    read them back (``_frames``).
    """
    _chunk_size(cfg, state, blocks)
    fr, fi = _frames(cfg, blocks)                     # (K, [C,] bins)
    state, outs = _timeline_engine(
        cfg, state, fr.movedim(0, -2), fi.movedim(0, -2),
        _gather_mac(cfg, *_widen(cfg, state.spec_h_re.unsqueeze(-3),
                                 state.spec_h_im.unsqueeze(-3))))
    return state, outs.movedim(-2, 0).contiguous()


def pconv_chunk_tv(cfg: PconvConfig, state: PconvState, blocks_x: torch.Tensor,
                   blocks_h: torch.Tensor) -> Tuple[PconvState, torch.Tensor]:
    """K consecutive time-varying blocks in one call, 1 <= K <= nparts:
    blocks_x and blocks_h (K, [C,] pts) -> outs (K, [C,] pts).

    Bit-equal to K sequential ``pconv_step_tv`` calls on the CPU
    (``pconv.py:635-715``).
    The input side is ``pconv_chunk``'s; the coefficient ring turns the
    other way (wp2 decrements, cl_conv.cpp:519), so at block k of the chunk
    slot q holds the chunk's own coefficient frame d = (wp2 - q) mod nparts
    when d <= k, and its pre-chunk content otherwise.
    """
    k = _chunk_size(cfg, state, blocks_x, "blocks_x")
    if blocks_h.shape != blocks_x.shape:
        raise ValueError(f"blocks_h {tuple(blocks_h.shape)} must have the shape "
                         f"of blocks_x {tuple(blocks_x.shape)}")
    both = torch.stack([blocks_x.to(cfg.compute_dtype), blocks_h.to(cfg.compute_dtype)], 1)
    fr, fi = _frames(cfg, both)                       # (K, 2, [C,] bins)
    dev = fr.device
    d = (state.wp2 - torch.arange(cfg.nparts, device=dev)) % cfg.nparts
    dcl = d.clamp(max=k - 1)
    sel = (d[None] <= torch.arange(k, device=dev)[:, None])[..., None]    # (K, np, 1)
    hnew = tuple(f[:, 1].movedim(0, -2)[..., dcl, :] for f in (fr, fi))   # ([C,] np, b)
    hold = _widen(cfg, state.spec_h_re, state.spec_h_im)
    hk = [torch.where(sel, n.unsqueeze(-3), o.unsqueeze(-3)) for n, o in zip(hnew, hold)]
    last = (d <= k - 1)[:, None]
    state = state._replace(
        spec_h_re=torch.where(last, hnew[0].to(cfg.storage_dtype), state.spec_h_re),
        spec_h_im=torch.where(last, hnew[1].to(cfg.storage_dtype), state.spec_h_im),
        wp2=(state.wp2 - k) % cfg.nparts)
    state, outs = _timeline_engine(cfg, state, fr[:, 0].movedim(0, -2),
                                   fi[:, 0].movedim(0, -2), _gather_mac(cfg, *hk))
    return state, outs.movedim(-2, 0).contiguous()


def _check_blocks(cfg: PconvConfig, blocks: torch.Tensor, name: str = "blocks",
                  channels: Optional[int] = None):
    """blocks must be (nblocks, pts), or (nblocks, channels, pts) for a
    batched stream, and float32 on a card where the kernels take the config
    (``_kernel_eligible``); every partition size runs."""
    shape = (cfg.pts,) if channels is None else (channels, cfg.pts)
    if blocks.dim() != len(shape) + 1 or tuple(blocks.shape[1:]) != shape:
        want = ", ".join(["nblocks", *map(str, shape)])
        raise ValueError(f"{name} must be ({want}), got {tuple(blocks.shape)}")
    if cfg._kernel_eligible() and blocks.is_cuda and blocks.dtype != torch.float32:
        raise TypeError(f"CUDA {name} must be float32, got {blocks.dtype}")


def _check_pair(cfg: PconvConfig, blocks_x: torch.Tensor, blocks_h: torch.Tensor,
                channels: Optional[int] = None):
    """A TV path's two operands: each as ``_check_blocks`` takes it, one
    shape."""
    _check_blocks(cfg, blocks_x, "blocks_x", channels)
    _check_blocks(cfg, blocks_h, "blocks_h", channels)
    if blocks_h.shape != blocks_x.shape:
        raise ValueError(f"blocks_h {tuple(blocks_h.shape)} must have the shape "
                         f"of blocks_x {tuple(blocks_x.shape)}")


def _batched_channels(state: PconvState) -> int:
    """Channel count of a batched state; per-channel pointers must match."""
    if state.spec_h_re.dim() != 3:
        raise ValueError(f"a batched state has (C, nparts, bins) planes, got "
                         f"spec_h_re {tuple(state.spec_h_re.shape)}")
    nch = state.spec_h_re.shape[0]
    for name in ("wp", "wp2"):
        p = getattr(state, name)
        if isinstance(p, tuple) and len(p) != nch:
            raise ValueError(f"{name} needs one pointer per channel ({nch}), got {len(p)}")
    return nch


def _advance(p: Pointers, n: int, nparts: int) -> Pointers:
    """Ring pointer(s) moved by n blocks, mod nparts."""
    if isinstance(p, tuple):
        return tuple((x + n) % nparts for x in p)
    return (p + n) % nparts


def _as_batch(state: PconvState) -> PconvState:
    """A single-channel state as a batched state of one channel (its planes
    views with a leading axis of 1, its int pointers shared); ``_channel(.,
    0)`` is the way back."""
    return state._replace(**{n: getattr(state, n)[None] for n in _PLANES})


def _channel(state: PconvState, c: int) -> PconvState:
    """Channel c of a batched state, with its own ring pointers."""
    return state._replace(**{n: getattr(state, n)[c] for n in _PLANES},
                          **{n: p[c] if isinstance(p, tuple) else p
                             for n, p in (("wp", state.wp), ("wp2", state.wp2))})


# the gathered MAC windows of one chunk of ``_plain_stream``, ([C,] K,
# nparts, bins), in elements: 128 MiB of float32 a plane
_CHUNK_WINDOW_ELEMENTS = 1 << 25


def _plain_stream(cfg: PconvConfig, state: PconvState, *blocks: torch.Tensor
                  ) -> Tuple[PconvState, torch.Tensor]:
    """The stream of a config the kernels do not take (``_kernel_eligible``):
    (nblocks, ...) blocks, or blocks_x and blocks_h for the TV streams,
    through ``pconv_chunk`` / ``pconv_chunk_tv`` in chunks of at most nparts
    blocks, each chunk's gathered windows held under
    _CHUNK_WINDOW_ELEMENTS. The chunks are bit-equal to sequential steps on
    the CPU (the JAX package scans the step), with one forward product and
    one inverse transform a chunk. A batched state with per-channel ring
    pointers runs channel by channel (the chunk engine takes shared
    pointers; the JAX package vmaps the step over them)."""
    if isinstance(state.wp, tuple) or isinstance(state.wp2, tuple):
        per = [_plain_stream(cfg, _channel(state, c), *(b[:, c] for b in blocks))
               for c in range(state.tail.shape[0])]
        stacked = {n: torch.stack([getattr(st, n) for st, _ in per]) for n in _PLANES}
        ptrs = {n: tuple(getattr(st, n) for st, _ in per) if isinstance(getattr(state, n), tuple)
                else getattr(per[0][0], n) for n in ("wp", "wp2")}
        return state._replace(**stacked, **ptrs), torch.stack([o for _, o in per], 1)
    per_block = state.tail.numel() // cfg.pts * cfg.nparts * cfg.bins
    k = max(1, min(cfg.nparts, _CHUNK_WINDOW_ELEMENTS // per_block))
    chunk = pconv_chunk if len(blocks) == 1 else pconv_chunk_tv
    outs = []
    for c0 in range(0, blocks[0].shape[0], k):
        state, out = chunk(cfg, state, *(b[c0:c0 + k] for b in blocks))
        outs.append(out)
    return state, torch.cat(outs)


def _gather_rows(planes: torch.Tensor, first: Tuple[int, ...], n: int) -> torch.Tensor:
    """Rows (first_c + q) mod rows, q < n, of each channel c of (C, rows, bins)."""
    rows = planes.shape[-2]
    idx = (torch.tensor(first, device=planes.device)[:, None]
           + torch.arange(n, device=planes.device)) % rows
    return torch.gather(planes, -2, idx[..., None].expand(-1, -1, planes.shape[-1]))


def _window(cfg: PconvConfig, state: PconvState) -> Cplx:
    """MAC window row q = frame (wp + q): doubled-ring rows [wp, wp+nparts),
    each channel at its own wp when the pointers are per channel."""
    wp = state.wp
    if isinstance(wp, tuple):
        return (_gather_rows(state.spec_x_re, wp, cfg.nparts),
                _gather_rows(state.spec_x_im, wp, cfg.nparts))
    return (state.spec_x_re[..., wp:wp + cfg.nparts, :].contiguous(),
            state.spec_x_im[..., wp:wp + cfg.nparts, :].contiguous())


def _doubled_ring(w: torch.Tensor, wp: Pointers) -> torch.Tensor:
    """Doubled input ring from a window whose row q holds frame (wp + q):
    ring[r] = W[(r - wp) mod nparts], per channel for per-channel wp."""
    if isinstance(wp, tuple):
        ring = _gather_rows(w, tuple(-p for p in wp), w.shape[-2])
    else:
        ring = torch.roll(w, wp, -2)
    return torch.cat([ring, ring], -2)


def pconv_stream(cfg: PconvConfig, state: PconvState, blocks: torch.Tensor
                 ) -> Tuple[PconvState, torch.Tensor]:
    """Run many LTI blocks, blocks: (nblocks, pts) -> outs (nblocks, pts).

    The one-channel case of ``pconv_stream_batched``: every block goes
    through one whole-scan kernel launch, its CUDA kernel for a CUDA tensor,
    its plain twin for a CPU tensor, and is traced as there. Same per-block
    results as pconv_step. A config the kernels do not take
    (``_kernel_eligible``: bf16 rings, float64) runs ``_plain_stream``:
    ``pconv_chunk`` over chunks of up to nparts blocks.
    """
    _check_blocks(cfg, blocks)
    if blocks.shape[0] == 0:
        return state, blocks.new_zeros((0, cfg.pts), dtype=cfg.compute_dtype)
    if not cfg._kernel_eligible():
        return _plain_stream(cfg, state, blocks)
    one, outs = pconv_stream_batched(cfg, _as_batch(state), blocks[:, None])
    return _channel(one, 0), outs[:, 0]


def pconv_stream_tv(cfg: PconvConfig, state: PconvState, blocks_x: torch.Tensor,
                    blocks_h: torch.Tensor) -> Tuple[PconvState, torch.Tensor]:
    """Run many time-varying blocks: blocks_x (input) and blocks_h
    (coefficient operand), both (nblocks, pts) -> outs (nblocks, pts).

    The one-channel case of ``pconv_stream_batched_tv``: every block goes
    through one whole-scan TV kernel launch, its CUDA kernel for CUDA
    tensors, its plain twin for CPU tensors, and is traced as there. Same
    per-block results as pconv_step_tv. The IR ring goes in and comes out
    in place, in the state's layout. A config the kernels do not take runs
    ``_plain_stream`` (``pconv_chunk_tv`` a chunk), as ``pconv_stream`` does.
    """
    _check_pair(cfg, blocks_x, blocks_h)
    if blocks_x.shape[0] == 0:
        return state, blocks_x.new_zeros((0, cfg.pts), dtype=cfg.compute_dtype)
    if not cfg._kernel_eligible():
        return _plain_stream(cfg, state, blocks_x, blocks_h)
    one, outs = pconv_stream_batched_tv(cfg, _as_batch(state), blocks_x[:, None],
                                        blocks_h[:, None])
    return _channel(one, 0), outs[:, 0]


def pconv_stream_batched(cfg: PconvConfig, state: PconvState, blocks: torch.Tensor
                         ) -> Tuple[PconvState, torch.Tensor]:
    """Run many LTI blocks of C channels: blocks (nblocks, C, pts) -> outs
    (nblocks, C, pts), on a batched state (``models.batched_state``) whose
    ring pointers are shared ints or length-C tuples.

    Every block of every channel goes through one launch of the batched
    whole-scan kernel (``stream_steps_fused_batched``): its CUDA kernel for
    a CUDA tensor, its plain twin for a CPU tensor. Same per-block results
    as pconv_step on each channel. A config the kernels do not take runs
    ``_plain_stream``, as ``pconv_stream`` does.

    Traced as the spans ``window`` (``_window``), ``launch`` (the scan
    wrapper's call, up to the return of its enqueue) and ``ring`` (the
    doubled rings rebuilt), as is ``pconv_stream``, its one-channel case.
    """
    nch = _batched_channels(state)
    _check_blocks(cfg, blocks, channels=nch)
    nb = blocks.shape[0]
    if nb == 0:
        return state, blocks.new_zeros((0, nch, cfg.pts), dtype=cfg.compute_dtype)
    if not cfg._kernel_eligible():
        return _plain_stream(cfg, state, blocks)
    return _stream_scan(cfg, state, blocks, stream_steps_fused_batched)


def _stream_scan(cfg: PconvConfig, state: PconvState, blocks: torch.Tensor, scan
                 ) -> Tuple[PconvState, torch.Tensor]:
    """The kernel route of the LTI streams on a state with shared int
    pointers or (``pconv_stream_batched``) one per channel: the window,
    ``scan(blocks, window, h, b0_scale, tails, pts)`` (an LTI scan entry's
    wrapper: ``stream_steps_fused_batched``, or for a matrix state of n_in
    rings, the n_out n_in pairs' IR planes and n_out tails,
    ``stream_steps_fused_matrix``) and the doubled rings rebuilt from its
    final windows, traced as the spans ``window``, ``launch`` (up to the
    return of the wrapper's enqueue) and ``ring``."""
    blocks = blocks.to(torch.float32).contiguous()
    with profiling.span("window"):
        window = _window(cfg, state)
    with profiling.span("launch"):
        outs, (wfr, wfi), tails = scan(blocks, window, (state.spec_h_re, state.spec_h_im),
                                       cfg.b0_scale, state.tail, cfg.pts)
    wp_out = _advance(state.wp, blocks.shape[0], cfg.nparts)
    with profiling.span("ring"):
        xr, xi = _doubled_ring(wfr, wp_out), _doubled_ring(wfi, wp_out)
    return state._replace(spec_x_re=xr, spec_x_im=xi, tail=tails, wp=wp_out), outs


def pconv_stream_batched_tv(cfg: PconvConfig, state: PconvState, blocks_x: torch.Tensor,
                            blocks_h: torch.Tensor) -> Tuple[PconvState, torch.Tensor]:
    """Run many time-varying blocks of C channels: blocks_x and blocks_h
    (nblocks, C, pts) -> outs (nblocks, C, pts), on a batched state whose
    ring pointers are shared ints or length-C tuples.

    Every block of every channel goes through one launch of the batched
    whole-scan TV kernel (``stream_steps_fused_batched_tv``): its CUDA kernel
    for CUDA tensors, its plain twin for CPU tensors. Same per-block results
    as pconv_step_tv on each channel; the IR rings go in and come out in the
    state's layout. A config the kernels do not take runs ``_plain_stream``.
    Traced as ``pconv_stream_batched``.
    """
    nch = _batched_channels(state)
    _check_pair(cfg, blocks_x, blocks_h, nch)
    nb = blocks_x.shape[0]
    if nb == 0:
        return state, blocks_x.new_zeros((0, nch, cfg.pts), dtype=cfg.compute_dtype)
    if not cfg._kernel_eligible():
        return _plain_stream(cfg, state, blocks_x, blocks_h)
    blocks_x = blocks_x.to(torch.float32).contiguous()
    blocks_h = blocks_h.to(torch.float32).contiguous()
    with profiling.span("window"):
        window = _window(cfg, state)
    with profiling.span("launch"):
        outs, (wfr, wfi), (hfr, hfi), tails = stream_steps_fused_batched_tv(
            blocks_x, blocks_h, window, (state.spec_h_re, state.spec_h_im), state.wp2,
            cfg.b0_scale, state.tail, cfg.pts)
    wp_out = _advance(state.wp, nb, cfg.nparts)
    with profiling.span("ring"):
        xr, xi = _doubled_ring(wfr, wp_out), _doubled_ring(wfi, wp_out)
    return state._replace(spec_x_re=xr, spec_x_im=xi, spec_h_re=hfr, spec_h_im=hfi,
                          tail=tails, wp=wp_out,
                          wp2=_advance(state.wp2, -nb, cfg.nparts)), outs


def _offline_batched(cfg: PconvConfig, state: PconvState, blocks: torch.Tensor
                     ) -> Tuple[PconvState, torch.Tensor]:
    """Batched offline LTI render: blocks (nb, C, pts) -> (nb, C, pts) on a
    batched state with shared ring pointers.

    The frequency-delay-line MAC is a pure sliding-window correlation over
    each channel's frame timeline (the ring holds exactly the last nparts
    spectra), so the render is ``_timeline_engine``: one forward product of
    every block, one sliding-MAC kernel launch over the timelines, one
    batched inverse transform and a vectorized overlap-add, with no
    sequential scan. The MAC runs through ``chunk_mac`` up to
    CHUNKMAC_MAX_BATCH channels and ``macflow_lti_batched`` above: one
    CUDA entry under the JAX package's two names, on the same timeline
    (``ops/cuda/slidemac.py``: the kernel for CUDA tensors, the twin for
    CPU tensors). Outputs match per-block streaming within float32
    reduction-order tolerance; the state chains exactly. A config the
    kernels do not take (``_kernel_eligible``) runs the twin's plain MAC
    (the JAX package's ``_lti_mac_xla``) on any device, on the frames
    rounded through the ring's dtype and the widened rings.
    """
    _check_offline(cfg, state, blocks)
    nb, nch = blocks.shape[:2]
    fr, fi = _frames(cfg, blocks)                     # (nb, C, bins)
    h = _widen(cfg, state.spec_h_re, state.spec_h_im)

    def mac(tl: Cplx) -> Cplx:
        if not cfg._kernel_eligible():
            return slide_mac_plain(tl, h, nb, cfg.b0_scale)
        if nch <= CHUNKMAC_MAX_BATCH:
            return chunk_mac(tl, h, cfg.b0_scale)
        return macflow_lti_batched(tl, h, nb, cfg.b0_scale)

    state, outs = _timeline_engine(cfg, state, fr.transpose(0, 1), fi.transpose(0, 1), mac)
    return state, outs.transpose(0, 1).contiguous()


def _check_offline(cfg: PconvConfig, state: PconvState, blocks: torch.Tensor):
    """blocks must be (nblocks >= 1, C, pts) for a batched state of C channels."""
    _check_blocks(cfg, blocks, channels=_batched_channels(state))
    if blocks.shape[0] < 1:
        raise ValueError("an offline render needs at least one block")


def pconv_offline(cfg: PconvConfig, state: PconvState, blocks: torch.Tensor
                  ) -> Tuple[PconvState, torch.Tensor]:
    """Offline LTI render of many blocks with no sequential dependence:
    blocks (nblocks >= 1, pts) -> (nblocks, pts).

    The one-channel case of ``_offline_batched``: one forward product, the
    ``chunk_mac`` kernel over the frame timeline, one inverse transform.
    Equals sequential ``pconv_step`` streaming within float32 tolerance
    (the kernel sums in another order); use ``pconv_stream`` or
    ``pconv_chunk`` where bit-equality with per-block streaming is needed.
    Every shape takes the kernel: there is no fall back to the scan. A
    config the kernels do not take runs ``pconv_stream`` (equal to
    sequential steps), as in the JAX package.
    """
    _check_blocks(cfg, blocks)
    if not cfg._kernel_eligible():
        return pconv_stream(cfg, state, blocks)
    one, outs = _offline_batched(cfg, _as_batch(state), blocks[:, None])
    return _channel(one, 0), outs[:, 0]


def pconv_stream_batched_chunked(cfg: PconvConfig, state: PconvState,
                                 blocks: torch.Tensor, K: int = 8
                                 ) -> Tuple[PconvState, torch.Tensor]:
    """Latency-relaxed batched streaming: blocks (nblocks, C, pts) in
    K-block chunks (K blocks of latency), each chunk through the offline
    engine ``_offline_batched`` (one forward product, one sliding-MAC
    launch, one inverse transform), so a channel's ring window is read once
    per chunk rather than once per block.

    nblocks must be a multiple of K. Outputs match per-block streaming
    within float32 reduction-order tolerance and the state chains exactly.
    A state with per-channel ring pointers goes to ``pconv_stream_batched``
    (the chunk engine takes shared pointers), as in the JAX package; its
    VMEM-envelope routing to the scan is a TPU rule and is not kept.
    """
    nch = _batched_channels(state)
    _check_blocks(cfg, blocks, channels=nch)
    nb = blocks.shape[0]
    if K < 1 or nb % K:
        raise ValueError(f"nblocks {nb} must be a multiple of K={K} >= 1")
    if isinstance(state.wp, tuple):
        return pconv_stream_batched(cfg, state, blocks)
    if nb == 0:
        return state, blocks.new_zeros((0, nch, cfg.pts), dtype=cfg.compute_dtype)
    outs = []
    for c0 in range(0, nb, K):
        state, out = _offline_batched(cfg, state, blocks[c0:c0 + K])
        outs.append(out)
    return state, torch.cat(outs)


def pconv_stream_batched_tv_chunked(cfg: PconvConfig, state: PconvState,
                                    blocks_x: torch.Tensor, blocks_h: torch.Tensor,
                                    K: int = 8) -> Tuple[PconvState, torch.Tensor]:
    """Latency-relaxed batched time-varying streaming: blocks_x and
    blocks_h (nblocks, C, pts) in K-block chunks (K blocks of latency),
    each chunk through the batched TV decomposed engine
    (``ops/decomposed.stream_batched_tv_decomposed``: one forward product of
    both operands, one TV sliding-MAC launch, one inverse transform).

    nblocks must be a multiple of K. Outputs match per-block streaming
    within float32 reduction-order tolerance and the state chains exactly.
    A state with per-channel ring pointers goes to
    ``pconv_stream_batched_tv`` (the chunk engine takes shared pointers), as
    in the JAX package; its rule that sends resident-kernel shapes to the
    scan is a TPU measurement and is not kept.
    """
    from .decomposed import stream_batched_tv_decomposed

    nch = _batched_channels(state)
    _check_pair(cfg, blocks_x, blocks_h, nch)
    nb = blocks_x.shape[0]
    if K < 1 or nb % K:
        raise ValueError(f"nblocks {nb} must be a multiple of K={K} >= 1")
    if isinstance(state.wp, tuple) or isinstance(state.wp2, tuple):
        return pconv_stream_batched_tv(cfg, state, blocks_x, blocks_h)
    if nb == 0:
        return state, blocks_x.new_zeros((0, nch, cfg.pts), dtype=cfg.compute_dtype)
    outs = []
    for c0 in range(0, nb, K):
        state, out = stream_batched_tv_decomposed(cfg, state, blocks_x[c0:c0 + K],
                                                  blocks_h[c0:c0 + K])
        outs.append(out)
    return state, torch.cat(outs)


def _on_device(name: str, signal, device) -> torch.device:
    """``convolve``'s device rule: an explicit device, else the signal's."""
    if device is not None:
        return torch.device(device)
    if not isinstance(signal, torch.Tensor):
        raise ValueError(f"{name}: pass device= for a non-tensor signal")
    return signal.device


def convolve_oneshot(signal, ir, impl: str = "auto",
                     device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """Full linear convolution in one zero-padded transform pair (the
    offline path, ``pconv.py:1394-1428``): len(signal) + len(ir) - 1
    samples, matching scipy.signal.fftconvolve to float32 tolerance.

    Both operands go through one n-point packed real transform (n the
    power of two >= the output length, at least 4), so on a card an
    n/2-point complex transform of 2^10..2^20 points runs the CUDA FFT
    kernel (``ops/cuda/vmemfft.py``). In the packed convention bin 0 carries
    (DC/2, Nyq/2), so its componentwise product takes a factor 2; the
    1/(n/2) scale rides the inverse transform. ``device``: as ``convolve``.
    """
    device = _on_device("convolve_oneshot", signal, device)
    signal = torch.as_tensor(signal, dtype=torch.float32, device=device)
    ir = torch.as_tensor(ir, dtype=torch.float32, device=device)
    out_len = signal.shape[-1] + ir.shape[-1] - 1
    n = 4
    while n < out_len:
        n <<= 1
    xr, xi = rfft_split(torch.nn.functional.pad(signal, (0, n - signal.shape[-1])), impl,
                        unnormalized=True)
    hr, hi = rfft_split(torch.nn.functional.pad(ir, (0, n - ir.shape[-1])), impl,
                        unnormalized=True)
    yr = xr * hr - xi * hi
    yi = xr * hi + xi * hr
    yr[..., 0] = 2.0 * xr[..., 0] * hr[..., 0]
    yi[..., 0] = 2.0 * xi[..., 0] * hi[..., 0]
    return irfft_split((yr, yi), impl, scale=2.0 / n)[..., :out_len]


def convolve(signal, ir, pts: int, bin0_mode: str = "exact",
             impl: str = "auto",
             device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """Full linear convolution of ``signal`` with ``ir`` via the streaming
    engine: len(signal) + len(ir) - 1 samples, matching
    scipy.signal.fftconvolve up to f32 tolerance (bin0_mode="exact").

    ``device``: where to run; defaults to the device of ``signal`` when it
    is a tensor (a numpy signal needs an explicit device).
    """
    device = _on_device("convolve", signal, device)
    signal = torch.as_tensor(signal, dtype=torch.float32, device=device)
    ir = torch.as_tensor(ir, dtype=torch.float32, device=device)
    cvs = -(-ir.shape[-1] // pts) * pts
    cfg = PconvConfig.for_ir_length(cvs, pts, bin0_mode=bin0_mode, impl=impl)
    out_len = signal.shape[-1] + ir.shape[-1] - 1
    nblocks = -(-(signal.shape[-1] + cvs) // pts)
    ir_p = torch.nn.functional.pad(ir, (0, cvs - ir.shape[-1]))
    sig_p = torch.nn.functional.pad(signal, (0, nblocks * pts - signal.shape[-1]))
    state = push_ir(cfg, pconv_init(cfg, device), ir_p)
    _, out = pconv_stream(cfg, state, sig_p.reshape(nblocks, pts))
    return out.reshape(-1)[:out_len]
