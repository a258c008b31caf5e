"""Batched streaming convolution engines: many channels at once.

Counterpart of ``opencl_fft_tpu/models/convolver.py``, the JAX package's
flagship models. ``Convolver`` (LTI, the ``clconv`` model at scale) and
``TVConvolver`` (time-varying, ``cltvconv`` at scale) run C channels in
lockstep on one batched state: every plane has a leading channel axis and
the ring pointers are shared. ``step`` is one block of every channel
through the per-block functions of ``ops/pconv.py``, which broadcast over
the channel axis (the JAX package vmaps them; on a card one block-step
kernel launch of ``ops/cuda/blockstep.py`` for all channels); ``stream``
sends a whole (nblocks, C, pts) scan through the batched whole-scan kernel
(``csrc/streamstep.cu``, through ``ops/cuda/streamstep.py``'s wrappers,
or ``ops/cuda/splitstep.py``'s above pts 2048), one launch sequence for
all channels, or with
``chunk > 1`` K blocks at a time through ``pconv_chunk`` (bit-equal to
per-block steps); ``TVConvolver.stream_chunked`` runs K-block chunks through
the batched TV decomposed engine (``pconv_stream_batched_tv_chunked``: one
TV sliding-MAC launch of ``ops/cuda/slidemac.py`` a chunk);
``Convolver.render`` is the offline render
(``_offline_batched``: one forward product, the sliding-MAC kernel of
``ops/cuda/slidemac.py``, one inverse transform). ``Convolver.set_ir`` is
the serving hot-swap: the chosen channels crossfade to new IRs over the
next steps (``pconv_begin_xfade`` / ``pconv_step_xfade`` on the whole
batch, the other channels' coefficients and tails left as they are, so
their outputs are bit-equal to an engine that never swapped).
``MatrixConvolver`` (true stereo and other matrices) rides on
``Convolver``; ``BatchedFFT`` is ``fft_split`` over leading axes.

Every engine takes an explicit device: a CUDA card (the default), or the
CPU when asked for by name, where each kernel's plain twin runs. A config
with bf16 rings or float64 compute keeps its rings and tails in those
dtypes and takes the plain composition of ``ops/pconv.py`` on either device
(``PconvConfig._kernel_eligible``).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops import pconv as _p
from ..ops.cplx import Cplx
from ..ops.fft import fft_split
from ..utils import profiling
from ..utils.devices import get_device

Device = Optional[Union[str, torch.device]]


def _device(device: Device) -> torch.device:
    return get_device(device=device, on_message=lambda msg, user_data: None)


def _cast(x, cfg: _p.PconvConfig, device: torch.device) -> torch.Tensor:
    """x as a tensor in the config's compute dtype on ``device``."""
    return torch.as_tensor(x, dtype=cfg.compute_dtype, device=device)


def _check_shape(name: str, x: torch.Tensor, shape) -> None:
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(x.shape)}")


def batched_state(cfg: _p.PconvConfig, batch: int, device: Device = None) -> _p.PconvState:
    """Zero state of ``batch`` channels on ``device`` (default: the card):
    every plane gains a leading channel axis; the ring pointers are shared
    (all channels advance in lockstep), wp = 0 and wp2 = nparts - 1. The
    rings are in the config's storage dtype (bf16 for ``ring_dtype="bf16"``)
    and the tail in its compute dtype (JAX ``models/convolver.py:32-40``)."""
    if batch < 1:
        raise ValueError(f"need at least one channel, got {batch}")
    dev = _device(device)

    def z(*shape, dtype=cfg.storage_dtype):
        return torch.zeros((batch, *shape), dtype=dtype, device=dev)

    return _p.PconvState(
        spec_x_re=z(2 * cfg.nparts, cfg.bins), spec_x_im=z(2 * cfg.nparts, cfg.bins),
        spec_h_re=z(cfg.nparts, cfg.bins), spec_h_im=z(cfg.nparts, cfg.bins),
        tail=z(cfg.pts, dtype=cfg.compute_dtype), wp=0, wp2=cfg.nparts - 1)


def _masked(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Per channel (the leading axis): ``new`` where ``mask``, else ``old``."""
    return torch.where(mask.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def _xfade_begin(cfg: _p.PconvConfig, state: _p.PconvState, irs: torch.Tensor,
                 mask: torch.Tensor) -> _p.XfadeState:
    """Batched ``pconv_begin_xfade`` that starts a fade only on the channels
    where ``mask`` (C,) is True (``models/convolver.py:269-278``): the
    others keep their coefficient ring and tail on both paths, so their
    blend is exactly a no-op. irs: (C, cvs); rows outside the mask are
    unused."""
    xf = _p.pconv_begin_xfade(cfg, state, irs)
    st = state._replace(spec_h_re=_masked(mask, xf.state.spec_h_re, state.spec_h_re),
                        spec_h_im=_masked(mask, xf.state.spec_h_im, state.spec_h_im),
                        tail=_masked(mask, xf.state.tail, state.tail))
    return xf._replace(state=st)


def _push_masked(cfg: _p.PconvConfig, state: _p.PconvState, irs: torch.Tensor,
                 mask: torch.Tensor) -> _p.PconvState:
    """Batched ``push_ir`` on the channels where ``mask`` is True: an
    instant swap (``models/convolver.py:285-290``)."""
    new = _p.push_ir(cfg, state, irs)
    return state._replace(spec_h_re=_masked(mask, new.spec_h_re, state.spec_h_re),
                          spec_h_im=_masked(mask, new.spec_h_im, state.spec_h_im))


def _mid_fade(what: str):
    raise RuntimeError(f"an IR crossfade is in progress: drive step() for the remaining "
                       f"fade blocks before {what}")


class Convolver:
    """Batched LTI convolution engine (the ``clconv`` model).

    batch channels, each convolving against its own IR of cfg.cvs samples.
    """

    def __init__(self, cfg: _p.PconvConfig, batch: int, device: Device = None):
        self.cfg = cfg
        self.batch = batch
        self.state = batched_state(cfg, batch, device)
        self.device = self.state.tail.device
        self._xf: Optional[_p.XfadeState] = None     # an IR crossfade in progress
        self._fade_pos = self._fade_total = 0

    def push_ir(self, irs) -> None:
        """irs: (batch, cvs). An instant swap; it ends any crossfade on the
        live input ring."""
        self._collapse_fade()
        self.state = _p.push_ir(self.cfg, self.state, _cast(irs, self.cfg, self.device))

    def _collapse_fade(self) -> None:
        if self._xf is not None:
            self.state = self._xf.state
            self._xf = None

    def set_ir(self, irs, channels: Optional[Sequence[int]] = None,
               fade_blocks: int = 8) -> None:
        """Replace per-channel IRs on the live batched stream (the serving
        hot-swap, ``models/convolver.py:120-169``): each swapped channel
        crossfades between its two exact convolutions over the next
        ``fade_blocks`` step() calls, while the other channels are
        bit-exactly unaffected.

        irs: (k, cvs) with ``channels`` a length-k index list, or (batch,
        cvs) with ``channels=None`` to swap every channel. ``fade_blocks=0``
        swaps at once (push_ir semantics, cl_conv.cpp:353-388: a click on a
        live stream). A second call mid-fade adopts the in-flight targets
        and fades to the new ones.
        """
        irs = _cast(irs, self.cfg, self.device)
        if irs.dim() != 2 or irs.shape[1] != self.cfg.cvs:
            raise ValueError(f"irs must be (k, {self.cfg.cvs}), got {tuple(irs.shape)}")
        if channels is None:
            if irs.shape[0] != self.batch:
                raise ValueError(f"channels=None needs (batch={self.batch}, cvs) irs, "
                                 f"got {tuple(irs.shape)}")
            full = irs
            mask = torch.ones(self.batch, dtype=torch.bool, device=self.device)
        else:
            idx = np.asarray(channels, np.int64).reshape(-1)
            if idx.size != irs.shape[0]:
                raise ValueError(f"{idx.size} channel indices for {irs.shape[0]} IRs")
            if idx.size != np.unique(idx).size:
                raise ValueError("duplicate channel indices")
            if idx.size and (idx.min() < 0 or idx.max() >= self.batch):
                raise ValueError(f"channel indices out of range [0, {self.batch})")
            rows = torch.from_numpy(idx).to(self.device)
            full = irs.new_zeros((self.batch, self.cfg.cvs))
            full[rows] = irs
            mask = torch.zeros(self.batch, dtype=torch.bool, device=self.device)
            mask[rows] = True
        if fade_blocks < 0:
            raise ValueError(f"fade_blocks must be >= 0, got {fade_blocks}")
        self._collapse_fade()
        if fade_blocks == 0:
            self.state = _push_masked(self.cfg, self.state, full, mask)
            return
        self._xf = _xfade_begin(self.cfg, self.state, full, mask)
        self._fade_pos, self._fade_total = 0, int(fade_blocks)

    def step(self, blocks) -> torch.Tensor:
        """blocks: (batch, pts) -> (batch, pts). During a crossfade, one
        fade block (``pconv_step_xfade``)."""
        blocks = _cast(blocks, self.cfg, self.device)
        _check_shape("blocks", blocks, (self.batch, self.cfg.pts))
        if self._xf is None:
            self.state, out = _p.pconv_step(self.cfg, self.state, blocks)
            return out
        # pconv_step_xfade broadcasts over the channels; one ramp for the
        # batch (every channel of a set_ir call fades on the same schedule)
        ramp = _p._xfade_ramp(self.cfg, self._fade_pos, self._fade_total, self.device)
        self._xf, out = _p.pconv_step_xfade(self.cfg, self._xf, blocks, ramp)
        self._fade_pos += 1
        if self._fade_pos >= self._fade_total:
            self._collapse_fade()
        return out

    def stream(self, blocks, chunk: int = 1) -> torch.Tensor:
        """Scan (nblocks, batch, pts) -> (nblocks, batch, pts): every block
        of every channel through the batched whole-scan kernel (the
        split scan above pts 2048).

        chunk > 1 takes that many blocks per ``pconv_chunk`` call instead
        (bit-equal to per-block ``step`` calls; nblocks must be a multiple
        of chunk and chunk <= nparts). Raises RuntimeError mid-fade.

        While a torch profiler records, each call is a ``stream`` request of
        ``utils.profiling``, the spans of the entry below it inside."""
        with profiling.request("stream", profiling.enabled()):
            if self._xf is not None:
                _mid_fade("bulk streaming")
            blocks = _cast(blocks, self.cfg, self.device)
            if chunk <= 1:
                self.state, out = _p.pconv_stream_batched(self.cfg, self.state, blocks)
                return out
            _check_shape("blocks", blocks, (len(blocks), self.batch, self.cfg.pts))
            if blocks.shape[0] % chunk:
                raise ValueError(f"nblocks {blocks.shape[0]} must be a multiple of chunk {chunk}")
            outs = []
            for c0 in range(0, blocks.shape[0], chunk):
                self.state, out = _p.pconv_chunk(self.cfg, self.state, blocks[c0:c0 + chunk])
                outs.append(out)
            return torch.cat(outs) if outs else blocks

    def render(self, blocks) -> torch.Tensor:
        """Offline batched render: (nblocks, batch, pts) -> the same shape,
        through ``_offline_batched``: the MAC is a sliding correlation over
        the precomputed frame spectra, so the render is batched transforms
        and one sliding-MAC kernel launch with no sequential scan. Output
        matches ``stream`` within float32 tolerance; latency is the whole
        render (``step``/``stream`` bound it). Raises RuntimeError
        mid-fade."""
        if self._xf is not None:
            _mid_fade("bulk rendering")
        self.state, out = _p._offline_batched(self.cfg, self.state,
                                              _cast(blocks, self.cfg, self.device))
        return out


class TVConvolver:
    """Batched time-varying convolution engine (the ``cltvconv`` model).

    Both operands stream per channel: each block's second operand becomes
    that channel's newest coefficient frame.
    """

    def __init__(self, cfg: _p.PconvConfig, batch: int, device: Device = None):
        self.cfg = cfg
        self.batch = batch
        self.state = batched_state(cfg, batch, device)
        self.device = self.state.tail.device

    def step(self, blocks_x, blocks_h) -> torch.Tensor:
        """(batch, pts) x 2 -> (batch, pts)."""
        bx, bh = (_cast(b, self.cfg, self.device) for b in (blocks_x, blocks_h))
        _check_shape("blocks_x", bx, (self.batch, self.cfg.pts))
        _check_shape("blocks_h", bh, (self.batch, self.cfg.pts))
        self.state, out = _p.pconv_step_tv(self.cfg, self.state, bx, bh)
        return out

    def stream(self, blocks_x, blocks_h) -> torch.Tensor:
        """Scan (nblocks, batch, pts) pairs -> (nblocks, batch, pts): every
        block of every channel through the batched whole-scan TV kernel
        (the split scan above pts 2048). Traced as ``Convolver.stream``."""
        with profiling.request("stream", profiling.enabled()):
            self.state, out = _p.pconv_stream_batched_tv(
                self.cfg, self.state,
                *(_cast(b, self.cfg, self.device) for b in (blocks_x, blocks_h)))
            return out

    def stream_chunked(self, blocks_x, blocks_h, K: int = 8) -> torch.Tensor:
        """Latency-relaxed TV serving: (nblocks, batch, pts) pairs in K-block
        chunks through ``pconv_stream_batched_tv_chunked`` (nblocks a
        multiple of K). Within float32 reduction-order tolerance of
        ``stream``; the state chains exactly."""
        self.state, out = _p.pconv_stream_batched_tv_chunked(
            self.cfg, self.state, *(_cast(b, self.cfg, self.device) for b in (blocks_x, blocks_h)),
            K=K)
        return out

    def step_fn(self):
        """The plain (state, bx, bh) -> (state, out) step on a batched
        state."""
        return functools.partial(_p.pconv_step_tv, self.cfg)


class MatrixConvolver:
    """True-stereo / matrix convolution: ``out[o] = sum_i in[i] * ir[o, i]``.

    Built on the batched ``Convolver`` with one channel per (out, in) IR
    pair, channel o*n_in + i: the input block is tiled across the n_out
    axis and the outputs are summed over n_in, so the whole matrix runs as
    one batched step or scan.
    """

    def __init__(self, cfg: _p.PconvConfig, n_in: int, n_out: int, device: Device = None):
        if n_in < 1 or n_out < 1:
            raise ValueError(f"need n_in, n_out >= 1, got {n_in}, {n_out}")
        self.cfg = cfg
        self.n_in = n_in
        self.n_out = n_out
        self._conv = Convolver(cfg, n_out * n_in, device)
        self.device = self._conv.device

    def push_ir(self, irs) -> None:
        """irs: (n_out, n_in, cvs)."""
        irs = _cast(irs, self.cfg, self.device)
        if irs.shape != (self.n_out, self.n_in, self.cfg.cvs):
            raise ValueError(
                f"irs must be ({self.n_out}, {self.n_in}, {self.cfg.cvs}), "
                f"got {tuple(irs.shape)}")
        self._conv.push_ir(irs.reshape(self.n_out * self.n_in, self.cfg.cvs))

    def set_ir(self, irs, entries: Optional[Sequence[Tuple[int, int]]] = None,
               fade_blocks: int = 8) -> None:
        """Hot-swap matrix entries on the live stream
        (``models/convolver.py:388-410``): irs (k, cvs) with ``entries`` a
        list of k (out, in) pairs, or (n_out, n_in, cvs) with
        ``entries=None`` for the whole matrix. Crossfaded as
        ``Convolver.set_ir`` (entries left alone are bit-exact)."""
        if entries is None:
            irs = _cast(irs, self.cfg, self.device)
            if irs.shape != (self.n_out, self.n_in, self.cfg.cvs):
                raise ValueError(
                    f"irs must be ({self.n_out}, {self.n_in}, {self.cfg.cvs}), "
                    f"got {tuple(irs.shape)}")
            self._conv.set_ir(irs.reshape(self.n_out * self.n_in, self.cfg.cvs),
                              fade_blocks=fade_blocks)
            return
        for o, i in entries:
            if not (0 <= o < self.n_out and 0 <= i < self.n_in):
                raise ValueError(f"entry ({o}, {i}) out of range "
                                 f"({self.n_out} x {self.n_in})")
        self._conv.set_ir(irs, channels=[o * self.n_in + i for o, i in entries],
                          fade_blocks=fade_blocks)

    def step(self, blocks) -> torch.Tensor:
        """blocks: (n_in, pts) -> (n_out, pts)."""
        blocks = _cast(blocks, self.cfg, self.device)
        if blocks.shape != (self.n_in, self.cfg.pts):
            raise ValueError(
                f"blocks must be ({self.n_in}, {self.cfg.pts}), "
                f"got {tuple(blocks.shape)}")
        out = self._conv.step(blocks.repeat(self.n_out, 1))
        return out.reshape(self.n_out, self.n_in, self.cfg.pts).sum(dim=1)

    def stream(self, blocks) -> torch.Tensor:
        """Scan (nblocks, n_in, pts) -> (nblocks, n_out, pts)."""
        blocks = _cast(blocks, self.cfg, self.device)
        if blocks.dim() != 3 or blocks.shape[1:] != (self.n_in, self.cfg.pts):
            raise ValueError(
                f"blocks must be (nblocks, {self.n_in}, {self.cfg.pts}), "
                f"got {tuple(blocks.shape)}")
        out = self._conv.stream(blocks.repeat(1, self.n_out, 1))
        return out.reshape(-1, self.n_out, self.n_in, self.cfg.pts).sum(dim=2)


class BatchedFFT:
    """Batched transform model (the ``clfft`` opcode at scale): many
    independent n-point complex transforms over the leading axes, on
    ``device`` (default: the card)."""

    def __init__(self, n: int, forward: bool = True, impl: str = "auto",
                 device: Device = None):
        self.n = n
        self.sign = -1 if forward else +1
        self.impl = impl
        self.device = _device(device)

    def __call__(self, x: Cplx) -> Cplx:
        re, im = (torch.as_tensor(p, device=self.device) for p in x)
        if re.shape[-1] != self.n:
            raise ValueError(f"transform size is {self.n}, got planes {tuple(re.shape)}")
        return fft_split((re, im), self.sign, self.impl)
