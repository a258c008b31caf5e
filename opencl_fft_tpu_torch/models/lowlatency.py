"""Zero-added-latency convolution: non-uniform (Gardner) partitioning.

Counterpart of ``opencl_fft_tpu/models/lowlatency.py``. The reference's
streaming convolution carries one partition of latency by construction
(``csound/opcode.cpp:240-249`` reads the previous block's output). Gardner's
scheme (1995, "Efficient convolution without input-output delay") removes
it: a direct head convolves the first ``block`` taps in the time domain,
and frequency-domain segments whose partition size doubles with their
offset into the IR cover the rest, so each segment's one-partition engine
latency hides behind the delay its taps already impose. Step t (given
input blocks 0..t) emits y[tB : (t+1)B] of the full convolution.

The head is the direct engine (``ops/dconv.dconv_step``, plain PyTorch, as
the JAX package leaves it to XLA); each segment is one partitioned engine
(``ops/pconv.pconv_step``): on a card the doubling segments (pts <= 2048,
nparts 1) run the ``block_step_fwd_fused`` kernel, and a terminal segment at
pts > 2048 the forward FFT, ``block_mac_unpack`` and the inverse FFT.

Scheduling (asserted by ``plan_segments``): the head covers taps [0, B);
doubling segments cover [P, 2P) at partition size P = B, 2B, ... below
``pmax``; then one uniform engine at pts = pmax covers [pmax, ir_len). Every
segment starts at offset == pts, so each is consumed with engine-block
delay d = offset // pts = 1 (the queue takes any d >= 1).

Each engine fires on its own cadence, every r = pts // B base blocks, at
m = t mod r == r - 1. The JAX package makes that a ``lax.cond`` on a traced
counter; here ``t`` is a host int and the cadence host arithmetic, so a
step launches only the engines that fire. Per-segment queues of d + 1
engine output blocks realize the consumption delays, with the JAX rows:
row 1 is read, a firing engine rolls the queue by one and writes row d.
State keeps the JAX package's field layout (``ZLState``) so a stream can
cross packages (``interop.zl_state_{to,from}_numpy``).

While a torch profiler records (``utils.profiling``; ``process`` and
``render`` ask ``enabled()`` once a call unless given the answer), each
step is a ``zl`` request holding the spans ``head`` (the direct engine),
``segments`` (the accumulate, consume and queue bookkeeping, with each
firing's ``step`` inside) and, in ``process``, ``download`` (the output's
copy to the host), and counts ``zl.steps``, ``zl.fires`` (engine
firings), ``zl.terminal_fires`` (those of the last segment), ``zl.step_ns``
(host ns in the step) and ``zl.download_ns``. Off, a step records nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..ops import dconv as _d
from ..ops import pconv as _p
from ..utils import profiling
from ..utils.devices import get_device
from ..utils.numerics import is_pow2

Device = Optional[Union[str, torch.device]]

_NULL = contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class Segment:
    """One frequency-domain segment of the non-uniform partition."""

    offset: int   # first tap covered (multiple of pts)
    pts: int      # partition size (multiple of the base block B)
    nparts: int   # partitions in this segment (1 during doubling)
    delay: int    # consumption delay in engine blocks == offset // pts

    @property
    def length(self) -> int:
        return self.pts * self.nparts


def plan_segments(ir_len: int, block: int, pmax: int = 1024) -> List[Segment]:
    """Non-uniform partition schedule for an ``ir_len``-tap response.

    The head [0, block) is implicit (direct engine). Returns [] when the IR
    fits entirely in the head.
    """
    if not is_pow2(block):
        raise ValueError(f"block must be a power of two, got {block}")
    if not is_pow2(pmax) or pmax < block:
        raise ValueError(f"pmax must be a power of two >= block, got {pmax}")
    segs: List[Segment] = []
    off = block
    pts = block
    while off < ir_len:
        if pts < pmax:
            segs.append(Segment(offset=off, pts=pts, nparts=1, delay=1))
            off += pts
            pts *= 2
        else:
            nparts = -(-(ir_len - off) // pmax)        # ceil
            segs.append(Segment(offset=off, pts=pmax, nparts=nparts, delay=off // pmax))
            off += nparts * pmax
    # invariants the streaming step relies on
    cover = block
    for s in segs:
        assert s.offset == cover, (s, cover)
        assert s.offset % s.pts == 0 and s.delay == s.offset // s.pts
        assert s.delay >= 1
        cover += s.length
    assert cover >= ir_len
    return segs


class _SegState(NamedTuple):
    eng: _p.PconvState
    buf: torch.Tensor     # (pts,) input accumulation for the current engine block
    queue: torch.Tensor   # (delay + 1, pts) most recent engine outputs, oldest first


class ZLState(NamedTuple):
    """Whole-convolver streaming state, in the JAX package's field layout
    (``t`` a host int here)."""

    t: int                          # base-block counter
    head: _d.DconvState
    segs: Tuple[_SegState, ...]


class ZeroLatencyConvolver:
    """Streaming convolution with no added latency (non-uniform scheme).

    >>> zl = ZeroLatencyConvolver(ir, block=64)
    >>> out = zl.process(in_block)          # (64,) -> (64,), zero latency

    ``block`` is the host I/O granularity; ``pmax`` caps the largest
    partition (throughput rises and per-step jitter falls with pmax, at no
    latency cost: the cap only bounds the terminal engine's transform
    size). ``device``: None/"cuda" for the card, or "cpu".
    """

    def __init__(self, ir, block: int = 64, pmax: int = 1024, impl: str = "auto",
                 device: Device = None):
        ir = np.asarray(ir, np.float32).reshape(-1)
        if ir.size < 1:
            raise ValueError("empty impulse response")
        self.ir_len = ir.size
        self.block = int(block)
        self.segments = plan_segments(ir.size, self.block, int(pmax))
        self.device = dev = get_device(device=device, on_message=lambda msg, user_data: None)
        self._head_cfg = _d.DconvConfig(irsize=self.block, vsize=self.block)
        head_ir = np.zeros(self.block, np.float32)
        head_ir[:min(self.block, ir.size)] = ir[:self.block]
        head = _d.push_ir(self._head_cfg, _d.dconv_init(self._head_cfg, dev),
                          torch.from_numpy(head_ir).to(dev))
        self._seg_cfgs = []
        seg_states = []
        for s in self.segments:
            cfg = _p.PconvConfig(pts=s.pts, nparts=s.nparts, impl=impl)
            self._seg_cfgs.append(cfg)
            seg_ir = np.zeros(cfg.cvs, np.float32)
            chunk = ir[s.offset:s.offset + s.length]
            seg_ir[:chunk.size] = chunk
            eng = _p.push_ir(cfg, _p.pconv_init(cfg, dev), torch.from_numpy(seg_ir).to(dev))
            seg_states.append(_SegState(
                eng=eng, buf=torch.zeros(s.pts, dtype=torch.float32, device=dev),
                queue=torch.zeros((s.delay + 1, s.pts), dtype=torch.float32, device=dev)))
        self.state = ZLState(t=0, head=head, segs=tuple(seg_states))

    # -- functional core ---------------------------------------------------

    def _step(self, state: ZLState, x: torch.Tensor, on: bool = False
              ) -> Tuple[ZLState, torch.Tensor]:
        """One base block x (B,) on the device -> (new state, y (B,)); the
        given state is left as it is. ``on``: traced (inside a ``zl``
        request), see the module's docstring."""
        t0 = time.time_ns() if on else 0
        B, t = self.block, state.t
        with profiling.span("head") if on else _NULL:
            head, y = _d.dconv_step(self._head_cfg, state.head, x)
        new_segs = []
        fires, fired = 0, False
        with profiling.span("segments") if on else _NULL:
            for s, cfg, st in zip(self.segments, self._seg_cfgs, state.segs):
                r = s.pts // B
                m = t % r
                # 1) accumulate this base block into the engine buffer
                buf = st.buf.clone()
                buf[m * B:(m + 1) * B] = x
                # 2) consume: queue row 1 holds engine block t//r - delay
                y = y + st.queue[1, m * B:(m + 1) * B]
                # 3) fire on the engine's cadence
                eng, queue = st.eng, st.queue
                fired = m == r - 1
                if fired:
                    eng, z = _p.pconv_step(cfg, eng, buf)
                    queue = torch.roll(queue, -1, 0)
                    queue[s.delay] = z
                    fires += 1
                new_segs.append(_SegState(eng=eng, buf=buf, queue=queue))
        if on:          # ``fired``: the last segment's
            profiling.count(("zl.steps", 1), ("zl.fires", fires), ("zl.terminal_fires", fired),
                            ("zl.step_ns", time.time_ns() - t0))
        return ZLState(t=t + 1, head=head, segs=tuple(new_segs)), y

    # -- host surface -------------------------------------------------------

    def process(self, block, on: Optional[bool] = None) -> np.ndarray:
        """One base block in, one base block out: zero added latency.
        ``on``: whether a profiler records (``profiling.enabled()``), if
        the caller has asked already."""
        x = np.asarray(block, np.float32).reshape(-1)
        if x.shape != (self.block,):
            raise ValueError(f"expected a ({self.block},) block, got {x.shape}")
        if on is None:
            on = profiling.enabled()
        with profiling.request("zl", on):
            self.state, y = self._step(self.state, torch.from_numpy(x).to(self.device), on)
            if not on:
                return y.cpu().numpy()
            t0 = time.time_ns()
            with profiling.span("download"):
                out = y.cpu().numpy()
            profiling.count(("zl.download_ns", time.time_ns() - t0))
        return out

    def render(self, signal) -> np.ndarray:
        """Offline convenience: stream a whole signal (padded to blocks)
        through the zero-latency step; returns the full convolution, tail
        included. The blocks go to the device at once and the outputs come
        back once, at the end."""
        sig = np.asarray(signal, np.float32).reshape(-1)
        total = sig.size + self.ir_len - 1
        nblocks = -(-total // self.block)
        pad = np.zeros(nblocks * self.block, np.float32)
        pad[:sig.size] = sig
        blocks = torch.from_numpy(pad.reshape(nblocks, self.block)).to(self.device)
        on = profiling.enabled()
        ys = []
        for blk in blocks:
            with profiling.request("zl", on):
                self.state, y = self._step(self.state, blk, on)
            ys.append(y)
        return torch.stack(ys).reshape(-1)[:total].cpu().numpy()

    def reset(self) -> None:
        """Zero the streaming state (keeps the analyzed IR spectra)."""
        head = self.state.head
        self.state = ZLState(
            t=0, head=head._replace(delay=torch.zeros_like(head.delay), wp=0),
            segs=tuple(st._replace(
                eng=st.eng._replace(spec_x_re=torch.zeros_like(st.eng.spec_x_re),
                                    spec_x_im=torch.zeros_like(st.eng.spec_x_im),
                                    tail=torch.zeros_like(st.eng.tail), wp=0),
                buf=torch.zeros_like(st.buf), queue=torch.zeros_like(st.queue))
                for st in self.state.segs))
