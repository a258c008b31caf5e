"""Batched streaming convolution engines: many channels at once.

Counterpart of ``opencl_fft_tpu/models/convolver.py``, the JAX package's
flagship models. ``Convolver`` (LTI, the ``clconv`` model at scale) and
``TVConvolver`` (time-varying, ``cltvconv`` at scale) run C channels in
lockstep on one batched state: every plane has a leading channel axis and
the ring pointers are shared. ``step`` is one block of every channel
through the per-block functions of ``ops/pconv.py``, which broadcast over
the channel axis (the JAX package vmaps them); ``stream`` sends a whole
(nblocks, C, pts) scan through the batched whole-scan kernel
(``ops/cuda/streamstep.py``), one launch sequence for all channels, or
with ``chunk > 1`` K blocks at a time through ``pconv_chunk`` (bit-equal to
per-block steps); ``Convolver.render`` is the offline render
(``_offline_batched``: one forward product, the sliding-MAC kernel of
``ops/cuda/slidemac.py``, one inverse transform). ``MatrixConvolver``
(true stereo and other matrices) rides on ``Convolver``; ``BatchedFFT`` is
``fft_split`` over leading axes.

Every engine takes an explicit device: a CUDA card (the default), or the
CPU when asked for by name, where each kernel's plain twin runs. Not
ported yet, each raising NotImplementedError naming its ROADMAP item: IR
hot-swap (``set_ir``, queue 1 item 11) and the decomposed TV engine
(``TVConvolver.stream_chunked``, item 10).
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import torch

from ..ops import pconv as _p
from ..ops.cplx import Cplx
from ..ops.fft import fft_split
from ..utils.devices import get_device

Device = Optional[Union[str, torch.device]]


def _device(device: Device) -> torch.device:
    return get_device(device=device, on_message=lambda msg, user_data: None)


def _f32(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _check_shape(name: str, x: torch.Tensor, shape) -> None:
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(x.shape)}")


def batched_state(cfg: _p.PconvConfig, batch: int, device: Device = None) -> _p.PconvState:
    """Zero state of ``batch`` channels on ``device`` (default: the card):
    every plane gains a leading channel axis; the ring pointers are shared
    (all channels advance in lockstep), wp = 0 and wp2 = nparts - 1."""
    if batch < 1:
        raise ValueError(f"need at least one channel, got {batch}")
    dev = _device(device)

    def z(*shape):
        return torch.zeros((batch, *shape), dtype=torch.float32, device=dev)

    return _p.PconvState(
        spec_x_re=z(2 * cfg.nparts, cfg.bins), spec_x_im=z(2 * cfg.nparts, cfg.bins),
        spec_h_re=z(cfg.nparts, cfg.bins), spec_h_im=z(cfg.nparts, cfg.bins),
        tail=z(cfg.pts), wp=0, wp2=cfg.nparts - 1)


def _set_ir_not_ported():
    raise NotImplementedError(
        "IR hot-swap (set_ir) is not ported yet (ROADMAP queue 1 item 11)")


class Convolver:
    """Batched LTI convolution engine (the ``clconv`` model).

    batch channels, each convolving against its own IR of cfg.cvs samples.
    """

    def __init__(self, cfg: _p.PconvConfig, batch: int, device: Device = None):
        self.cfg = cfg
        self.batch = batch
        self.state = batched_state(cfg, batch, device)
        self.device = self.state.tail.device

    def push_ir(self, irs) -> None:
        """irs: (batch, cvs)."""
        self.state = _p.push_ir(self.cfg, self.state, _f32(irs, self.device))

    def set_ir(self, irs, channels=None, fade_blocks: int = 8) -> None:
        _set_ir_not_ported()

    def step(self, blocks) -> torch.Tensor:
        """blocks: (batch, pts) -> (batch, pts)."""
        blocks = _f32(blocks, self.device)
        _check_shape("blocks", blocks, (self.batch, self.cfg.pts))
        self.state, out = _p.pconv_step(self.cfg, self.state, blocks)
        return out

    def stream(self, blocks, chunk: int = 1) -> torch.Tensor:
        """Scan (nblocks, batch, pts) -> (nblocks, batch, pts): every block
        of every channel through the batched whole-scan kernel.

        chunk > 1 takes that many blocks per ``pconv_chunk`` call instead
        (bit-equal to per-block ``step`` calls; nblocks must be a multiple
        of chunk and chunk <= nparts)."""
        blocks = _f32(blocks, self.device)
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
        render (``step``/``stream`` bound it)."""
        self.state, out = _p._offline_batched(self.cfg, self.state,
                                              _f32(blocks, self.device))
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
        bx, bh = _f32(blocks_x, self.device), _f32(blocks_h, self.device)
        _check_shape("blocks_x", bx, (self.batch, self.cfg.pts))
        _check_shape("blocks_h", bh, (self.batch, self.cfg.pts))
        self.state, out = _p.pconv_step_tv(self.cfg, self.state, bx, bh)
        return out

    def stream(self, blocks_x, blocks_h) -> torch.Tensor:
        """Scan (nblocks, batch, pts) pairs -> (nblocks, batch, pts): every
        block of every channel through the batched whole-scan TV kernel."""
        self.state, out = _p.pconv_stream_batched_tv(
            self.cfg, self.state, _f32(blocks_x, self.device), _f32(blocks_h, self.device))
        return out

    def stream_chunked(self, blocks_x, blocks_h, K: int = 8) -> torch.Tensor:
        raise NotImplementedError(
            "the chunked TV engine (stream_chunked) is not ported yet "
            "(ROADMAP queue 1 item 10)")

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
        irs = _f32(irs, self.device)
        if irs.shape != (self.n_out, self.n_in, self.cfg.cvs):
            raise ValueError(
                f"irs must be ({self.n_out}, {self.n_in}, {self.cfg.cvs}), "
                f"got {tuple(irs.shape)}")
        self._conv.push_ir(irs.reshape(self.n_out * self.n_in, self.cfg.cvs))

    def set_ir(self, irs, entries=None, fade_blocks: int = 8) -> None:
        _set_ir_not_ported()

    def step(self, blocks) -> torch.Tensor:
        """blocks: (n_in, pts) -> (n_out, pts)."""
        blocks = _f32(blocks, self.device)
        if blocks.shape != (self.n_in, self.cfg.pts):
            raise ValueError(
                f"blocks must be ({self.n_in}, {self.cfg.pts}), "
                f"got {tuple(blocks.shape)}")
        out = self._conv.step(blocks.repeat(self.n_out, 1))
        return out.reshape(self.n_out, self.n_in, self.cfg.pts).sum(dim=1)

    def stream(self, blocks) -> torch.Tensor:
        """Scan (nblocks, n_in, pts) -> (nblocks, n_out, pts)."""
        blocks = _f32(blocks, self.device)
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
