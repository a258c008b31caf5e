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
(``csrc/streamstep.cu``, through ``ops/cuda/streamstep.py``'s
``stream_steps_fused_batched{,_tv}`` at every pts), one launch sequence for
all channels, or with
``chunk > 1`` K blocks at a time through ``pconv_chunk`` (bit-equal to
per-block steps); ``TVConvolver.stream_chunked`` runs K-block chunks through
the batched TV decomposed engine (``pconv_stream_batched_tv_chunked``: one
TV sliding-MAC launch of ``ops/cuda/slidemac.py`` a chunk);
``Convolver.render`` is the offline render
(``_offline_batched``: one forward product, the sliding-MAC kernel of
``ops/cuda/slidemac.py``, one inverse transform). ``Convolver.set_ir`` is
the serving hot-swap: the chosen channels crossfade to new IRs over the
next steps. It analyses the IRs (``ir_planes``) and switches to their
coefficient planes (``Convolver._switch``: ``pconv_begin_xfade_planes`` /
``pconv_step_xfade`` on the whole batch, the other channels' coefficients
and tails left as they are, so their outputs are bit-equal to an engine
that never swapped). ``MatrixConvolver`` (true stereo and other matrices)
rides on ``Convolver``, its ``stream`` on the matrix scan entry; with a
bank of IRs analysed once on the device (``fill_bank``: a binaural
renderer's BRIRs, a head orientation each) its ``switch`` selects each
input's IRs by index and crossfades to them through the same
``_switch``, with no IR analysed. ``BatchedFFT`` is ``fft_split`` over
leading axes.

Every engine takes an explicit device: a CUDA card (the default), or the
CPU when asked for by name, where each kernel's plain twin runs. A config
with bf16 rings or float64 compute keeps its rings and tails in those
dtypes and takes the plain composition of ``ops/pconv.py`` on either device
(``PconvConfig._kernel_eligible``).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops import pconv as _p
from ..ops.cplx import Cplx
from ..ops.cuda.streamstep import stream_steps_fused_matrix
from ..ops.fft import fft_split
from ..utils import profiling
from ..utils.devices import get_device

Device = Optional[Union[str, torch.device]]
_NULL = contextlib.nullcontext()
_FILL_ROWS = 1 << 13      # partition rows ``fill_bank`` analyses at a time


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
        rows = None
        if channels is None:
            if irs.shape[0] != self.batch:
                raise ValueError(f"channels=None needs (batch={self.batch}, cvs) irs, "
                                 f"got {tuple(irs.shape)}")
        else:
            idx = np.asarray(channels, np.int64).reshape(-1)
            if idx.size != irs.shape[0]:
                raise ValueError(f"{idx.size} channel indices for {irs.shape[0]} IRs")
            if idx.size != np.unique(idx).size:
                raise ValueError("duplicate channel indices")
            if idx.size and (idx.min() < 0 or idx.max() >= self.batch):
                raise ValueError(f"channel indices out of range [0, {self.batch})")
            rows = torch.from_numpy(idx).to(self.device)
        if fade_blocks < 0:
            raise ValueError(f"fade_blocks must be >= 0, got {fade_blocks}")
        self._switch(*_p.ir_planes(self.cfg, irs, self.state.wp2), rows, fade_blocks)

    def _switch(self, h_re: torch.Tensor, h_im: torch.Tensor, rows: Optional[torch.Tensor],
                fade_blocks: int) -> None:
        """``set_ir`` of coefficient planes already analysed, (k, nparts,
        bins) each in the ring's slot order: the channels ``rows`` (k,) on
        the device, or every channel for None. Their coefficient rings take
        the planes and their tails are rebuilt (``pconv_begin_xfade_planes``);
        the other channels keep both, so their blend is exactly a no-op."""
        self._collapse_fade()
        st = self.state
        if rows is not None:
            h_re = st.spec_h_re.index_copy(0, rows, h_re)
            h_im = st.spec_h_im.index_copy(0, rows, h_im)
        profiling.add("xfade.switches", self.batch if rows is None else len(rows))
        if fade_blocks == 0:
            self.state = st._replace(spec_h_re=h_re, spec_h_im=h_im)
            return
        xf = _p.pconv_begin_xfade_planes(self.cfg, st, h_re, h_im)
        if rows is not None:
            tail = st.tail.index_copy(0, rows, xf.state.tail.index_select(0, rows))
            xf = xf._replace(state=xf.state._replace(tail=tail))
        self._xf = xf
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
        with profiling.span("xfade"):
            profiling.add("xfade.blocks")
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
    pair, channel o*n_in + i (the pair state): ``step``, ``push_ir``,
    ``set_ir`` and the crossfade tile the input block across the n_out axis
    and sum the outputs over n_in, so the whole matrix runs as one batched
    step. ``stream`` of a config the kernels take (``_kernel_eligible``)
    runs the matrix scan entry (``stream_steps_fused_matrix`` through
    ``ops/pconv._stream_scan``) on a compact state: one doubled input ring
    an input, one tail an output, the pairs' IR planes read from the pair
    state, which meanwhile holds no rings or tails. The two layouts convert
    when a caller switches between ``stream`` and the others: an input's
    ring is pair (0, i)'s (every output's copy is equal), output o's tail
    the sum of its pairs' tails; back, each ring is copied to its n_out
    pairs and each pair's tail is rebuilt from its ring and IR, as a
    crossfade rebuilds its incoming path's (after a scan of at least one
    block the tail is the last block's MAC and inverse transform, and a
    crossfade of one entry needs that entry's own tail). Any other config
    streams on the pair state, as ``step`` does.

    While a torch profiler records, each ``step`` or ``stream`` call is a
    ``matrix`` request of ``utils.profiling`` with the counters
    ``matrix.calls``, ``matrix.blocks``, ``matrix.pairs`` (n_out * n_in a
    block) and ``matrix.fan_bytes`` (the tiled input written and the
    per-pair output reduced; 0 on the matrix scan, which moves neither).
    On the pair routes it holds a span ``fanout`` around the tiling, the
    inner ``Convolver`` call (``stream`` is a request of its own) and a span
    ``fanin`` around the sum over inputs; on the matrix scan a ``stream``
    request of its own with the entry's spans inside. Off, the layer asks
    ``enabled()`` once a call.

    A bank of IRs (``fill_bank``: D orientations of every (in, out) pair,
    analysed once into coefficient planes on the device) lets ``switch``
    move each input's pairs to another orientation's IRs by index, every
    block if need be, as a head-tracked binaural renderer does: a gather of
    planes and ``set_ir``'s crossfade begin, no IR analysed. While a fade
    runs, each ``step`` holds an ``xfade`` span (``Convolver.step``) and
    counts ``xfade.blocks``.
    """

    def __init__(self, cfg: _p.PconvConfig, n_in: int, n_out: int, device: Device = None):
        if n_in < 1 or n_out < 1:
            raise ValueError(f"need n_in, n_out >= 1, got {n_in}, {n_out}")
        self.cfg = cfg
        self.n_in = n_in
        self.n_out = n_out
        self._conv = Convolver(cfg, n_out * n_in, device)
        self.device = self._conv.device
        self._compact: Optional[_p.PconvState] = None   # the current state, when compact
        self._bank: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        # the bank orientation whose planes each input's pairs hold (or fade
        # to); -1 where they hold others
        self._held = np.full(n_in, -1, np.int64)

    def push_ir(self, irs) -> None:
        """irs: (n_out, n_in, cvs)."""
        irs = _cast(irs, self.cfg, self.device)
        if irs.shape != (self.n_out, self.n_in, self.cfg.cvs):
            raise ValueError(
                f"irs must be ({self.n_out}, {self.n_in}, {self.cfg.cvs}), "
                f"got {tuple(irs.shape)}")
        self._to_pairs()
        self._conv.push_ir(irs.reshape(self.n_out * self.n_in, self.cfg.cvs))
        self._held[:] = -1

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
            self._to_pairs()
            self._conv.set_ir(irs.reshape(self.n_out * self.n_in, self.cfg.cvs),
                              fade_blocks=fade_blocks)
            self._held[:] = -1
            return
        for o, i in entries:
            if not (0 <= o < self.n_out and 0 <= i < self.n_in):
                raise ValueError(f"entry ({o}, {i}) out of range "
                                 f"({self.n_out} x {self.n_in})")
        self._to_pairs()
        self._conv.set_ir(irs, channels=[o * self.n_in + i for o, i in entries],
                          fade_blocks=fade_blocks)
        self._held[[i for _, i in entries]] = -1

    def fill_bank(self, irs, first: int = 0) -> None:
        """Analyse time-domain IRs into the bank of coefficient planes that
        ``switch`` selects from, kept on the engine's device: irs (k, D,
        n_out, cvs), the D orientations' IRs of inputs first .. first+k-1
        (a binaural room synthesis renderer's BRIRs: D head orientations of
        n_out ears a source). The bank, (n_in, D, n_out, nparts, bins) re and
        im planes in the ring's slot order (for the coefficient pointer
        nparts - 1, which no LTI step moves), is allocated (zeroed) by the
        first call and again when D changes, so a bank too large to analyse
        at once is filled in chunks of inputs. Each IR is analysed as
        ``push_ir`` analyses it (``ops/pconv.ir_planes``), once. While a
        torch profiler records, the allocation counts its bytes as
        ``bank.bytes``."""
        irs = _cast(irs, self.cfg, self.device)
        if irs.dim() != 4 or irs.shape[2:] != (self.n_out, self.cfg.cvs):
            raise ValueError(f"irs must be (k, D, {self.n_out}, {self.cfg.cvs}), "
                             f"got {tuple(irs.shape)}")
        k, d = irs.shape[:2]
        if d < 1 or not 0 <= first <= first + k <= self.n_in:
            raise ValueError(f"inputs {first} .. {first + k - 1} of D={d} orientations "
                             f"out of range ({self.n_in} inputs)")
        if self._bank is None or self._bank[0].shape[1] != d:
            self._bank = None       # the old bank's memory first
            shape = (self.n_in, d, self.n_out, self.cfg.nparts, self.cfg.bins)
            self._bank = tuple(torch.zeros(shape, dtype=self.cfg.storage_dtype,
                                           device=self.device) for _ in range(2))
            self._held[:] = -1
            if profiling.enabled():
                profiling.count(("bank.bytes", 2 * self._bank[0].nbytes))
        # a few orientations at a time: the analysis holds a float64 product
        # of 2·bins a partition row (``_forward_partition``)
        step = max(1, _FILL_ROWS // (self.n_out * self.cfg.nparts))
        for j in range(k):
            for d0 in range(0, d, step):
                hr, hi = _p.ir_planes(self.cfg, irs[j, d0:d0 + step], self.cfg.nparts - 1)
                self._bank[0][first + j, d0:d0 + step] = hr
                self._bank[1][first + j, d0:d0 + step] = hi
        self._held[first:first + k] = -1

    def switch(self, index, fade_blocks: int = 1) -> None:
        """Select each input's IRs from the bank (``fill_bank``): index
        (n_in,) ints, input i's orientation in [0, D). The pairs of every
        input whose index changed crossfade from their current planes to
        the bank's over the next ``fade_blocks`` ``step`` calls, as
        ``set_ir`` does (``fade_blocks=0`` swaps at once; a switch mid-fade
        adopts the targets in flight); the pairs of the others are left
        alone, bit-exactly, and a switch that changes no index does
        nothing. No IR is analysed and no IR data crosses from the host:
        the planes are gathered from the bank on the device. A switch on
        the compact state converts to the pair state first.

        While a torch profiler records, each call is a ``switch`` request
        with a span ``gather`` (the bank to planes selection) inside, and
        counts ``xfade.switches`` (pairs switched) and
        ``bank.gather_bytes`` (coefficient bytes written)."""
        if self._bank is None:
            raise RuntimeError("no IR bank: fill_bank() first")
        d = self._bank[0].shape[1]
        idx = np.asarray(index)
        if idx.shape != (self.n_in,) or not np.issubdtype(idx.dtype, np.integer):
            raise ValueError(f"index must be {self.n_in} ints, got {idx.dtype} {idx.shape}")
        if idx.min() < 0 or idx.max() >= d:
            raise ValueError(f"index out of range [0, {d})")
        if fade_blocks < 0:
            raise ValueError(f"fade_blocks must be >= 0, got {fade_blocks}")
        changed = np.flatnonzero(idx != self._held)
        if not changed.size:
            return
        on = profiling.enabled()
        with profiling.request("switch", on):
            self._to_pairs()
            n = self.n_in * self.n_out
            # pair o*n_in + i takes bank row ((i*D + index_i)*n_out + o)
            o, i = np.divmod(np.arange(n), self.n_in)
            src = (i * d + idx[i]) * self.n_out + o
            if changed.size < self.n_in:
                pairs = np.flatnonzero(np.isin(i, changed))
                sel = torch.from_numpy(np.stack([src[pairs], pairs])).to(self.device)
                src_t, rows = sel[0], sel[1]
            else:
                src_t, rows = torch.from_numpy(src).to(self.device), None
            with profiling.span("gather") if on else _NULL:
                planes = [bank.view(-1, self.cfg.nparts, self.cfg.bins).index_select(0, src_t)
                          for bank in self._bank]
            written = sum(p.nbytes for p in planes)
            if rows is not None:        # the switched rows' ring copies, written whole
                written += 2 * n * planes[0][0].nbytes
            self._conv._switch(*planes, rows, fade_blocks)
            self._held[changed] = idx[changed]
            if on:
                profiling.count(("bank.gather_bytes", written))

    def step(self, blocks) -> torch.Tensor:
        """blocks: (n_in, pts) -> (n_out, pts)."""
        on = profiling.enabled()
        with profiling.request("matrix", on):
            blocks = _cast(blocks, self.cfg, self.device)
            if blocks.shape != (self.n_in, self.cfg.pts):
                raise ValueError(
                    f"blocks must be ({self.n_in}, {self.cfg.pts}), "
                    f"got {tuple(blocks.shape)}")
            self._to_pairs()
            with profiling.span("fanout") if on else _NULL:
                tiled = blocks.repeat(self.n_out, 1)
            out = self._conv.step(tiled)
            with profiling.span("fanin") if on else _NULL:
                y = out.reshape(self.n_out, self.n_in, self.cfg.pts).sum(dim=1)
            if on:
                self._count(1, tiled.nbytes + out.nbytes)
            return y

    def stream(self, blocks) -> torch.Tensor:
        """Scan (nblocks, n_in, pts) -> (nblocks, n_out, pts). Raises
        RuntimeError mid-fade."""
        on = profiling.enabled()
        with profiling.request("matrix", on):
            blocks = _cast(blocks, self.cfg, self.device)
            if blocks.dim() != 3 or blocks.shape[1:] != (self.n_in, self.cfg.pts):
                raise ValueError(
                    f"blocks must be (nblocks, {self.n_in}, {self.cfg.pts}), "
                    f"got {tuple(blocks.shape)}")
            if self._compact is None and not self._scannable():
                with profiling.span("fanout") if on else _NULL:
                    tiled = blocks.repeat(1, self.n_out, 1)
                out = self._conv.stream(tiled)
                with profiling.span("fanin") if on else _NULL:
                    y = out.reshape(-1, self.n_out, self.n_in, self.cfg.pts).sum(dim=2)
                if on:
                    self._count(len(blocks), tiled.nbytes + out.nbytes)
                return y
            with profiling.request("stream", on):
                if self._conv._xf is not None:
                    _mid_fade("bulk streaming")
                if len(blocks):
                    self._compact, y = _p._stream_scan(self.cfg, self._to_compact(), blocks,
                                                       stream_steps_fused_matrix)
                else:
                    y = blocks.new_zeros((0, self.n_out, self.cfg.pts))
            if on:
                self._count(len(blocks), 0)
            return y

    def _scannable(self) -> bool:
        """Whether ``stream`` takes the matrix scan from the pair state."""
        return self.cfg._kernel_eligible()

    def _to_compact(self) -> _p.PconvState:
        """Make the compact state the current one, converted from the pair
        state if that is the current one, and return it. Its IR planes are
        the pair state's (only ``push_ir`` and ``set_ir`` change them, after
        ``_to_pairs``); the pair state keeps nothing else (its rings and
        tails are ``None``: ``_to_pairs`` rebuilds them)."""
        if self._compact is None:
            st = self._conv.state
            tail = st.tail.reshape(self.n_out, self.n_in, -1).sum(dim=1)
            self._compact = st._replace(spec_x_re=st.spec_x_re[:self.n_in].clone(),
                                        spec_x_im=st.spec_x_im[:self.n_in].clone(), tail=tail)
            self._conv.state = st._replace(spec_x_re=None, spec_x_im=None, tail=None)
        return self._compact

    def _to_pairs(self) -> None:
        """Make the pair state the current one, if the compact state is."""
        cm = self._compact
        if cm is None:
            return
        # the tail a pair had before is read only into the discarded block
        st = self._conv.state._replace(spec_x_re=cm.spec_x_re.repeat(self.n_out, 1, 1),
                                       spec_x_im=cm.spec_x_im.repeat(self.n_out, 1, 1),
                                       tail=cm.tail.new_zeros((self.n_out * self.n_in,
                                                               self.cfg.pts)),
                                       wp=cm.wp)
        _, tail = _p._mac_inverse_ola(self.cfg, st, st.wp)
        self._conv.state = st._replace(tail=tail)
        self._compact = None

    def _count(self, nblocks: int, fan_bytes: int) -> None:
        profiling.count(("matrix.calls", 1), ("matrix.blocks", nblocks),
                        ("matrix.pairs", self.n_out * self.n_in * nblocks),
                        ("matrix.fan_bytes", fan_bytes))


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
