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

On a CUDA card ``process`` replays captured CUDA graphs instead
(``_Phases``). A callback's work is fixed by its cadence phase t mod P, P
= the largest pts over B (at least 2, the head's ring period): the slices
each segment writes and reads, which segments fire, the head's ring
pointer (the segments of one partition keep theirs at 0). After a cycle of
eager steps the P graphs are captured, in phase order; each replays a
callback's whole stream of ops on tensors the path owns: the input's copy
from a pinned buffer, the head, every segment's accumulate and consume,
the firings of the segments of one partition, the output's copy into
pinned memory. A terminal segment of several partitions walks its ring
pointer, so it fires after the replay, on the same stream, while the host
waits for the output alone: above pts 2048 by the replay of its own graph,
which reads the pointer from device memory (``ops/pconv.StepGraph``), else
eagerly. The path engages on a card whose plan has P <= ``MAX_PHASES``. It
takes a state assigned from outside (``reset``, a checkpoint, ``interop``)
into its own tensors before the next replay, and leaves the work to the
eager step for a state whose head pointer is off the cadence and, for
good, once a capture fails (said once through ``on_message``). A state it publishes holds tensors that later
replays overwrite: copy it (``interop.zl_state_to_numpy``, a checkpoint)
to keep it. There a step is a ``zl`` request holding ``replay`` (the
terminal firing's ``step`` inside) and ``download``; the counters are
those above, ``zl.fires`` and ``step.blocks`` counted from the cadence on
the host, and ``zl.replays`` counts the steps a replay served (0 on a
card's eager steps).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..ops import dconv as _d
from ..ops import pconv as _p
from ..utils import profiling
from ..utils.devices import get_device
from ..utils.logging import MessageCallback
from ..utils.numerics import is_pow2

Device = Optional[Union[str, torch.device]]

_NULL = contextlib.nullcontext()

MAX_PHASES = 256    # the most cadence phases, one graph each, that ``_Phases`` captures


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
    size). ``device``: None/"cuda" for the card, or "cpu". On a card
    ``process`` replays one CUDA graph a cadence phase (the module's
    docstring); ``on_message(msg, user_data)`` hears, once, why that path
    went off, and is silent unless set (``ClconvProcessor`` sets its own).
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
        self.on_message: MessageCallback = lambda msg, user_data: None
        self.user_data = None
        self._phases = (_Phases(self) if dev.type == "cuda"
                        and _period(self.segments, self.block) <= MAX_PHASES else None)

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
        if self._phases is not None:
            out = self._phases.process(x, on)
            if out is not None:
                return out
        with profiling.request("zl", on):
            self.state, y = self._step(self.state, torch.from_numpy(x).to(self.device), on)
            if not on:
                return y.cpu().numpy()
            if self._phases is not None:
                profiling.count(("zl.replays", 0))
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


# -- the graph path ------------------------------------------------------------

_PLANES = ("spec_x_re", "spec_x_im", "spec_h_re", "spec_h_im", "tail")


def _period(segments: List[Segment], block: int) -> int:
    """The cadence period in base blocks: the largest segment's pts over
    the block, and at least 2, the period of the head's ring pointer."""
    return max([s.pts // block for s in segments] + [2])


def _own(state: ZLState, terminal: Optional[int], f) -> ZLState:
    """``state`` with f applied to each tensor that the phases read or
    write: the head's, every segment's buffer and queue, and the engine
    planes of every segment but the terminal one."""
    segs = tuple(_SegState(
        eng=st.eng if i == terminal else st.eng._replace(
            **{k: f(getattr(st.eng, k)) for k in _PLANES}),
        buf=f(st.buf), queue=f(st.queue)) for i, st in enumerate(state.segs))
    return ZLState(t=state.t, head=state.head._replace(delay=f(state.head.delay),
                                                       coefs=f(state.head.coefs)), segs=segs)


def _owned(state: ZLState, terminal: Optional[int]) -> List[torch.Tensor]:
    """The tensors of ``_own``, in its order."""
    out: List[torch.Tensor] = []

    def keep(t: torch.Tensor) -> torch.Tensor:
        out.append(t)
        return t

    _own(state, terminal, keep)
    return out


def _push(queue: torch.Tensor, z: torch.Tensor) -> None:
    """A firing's queue update in place at delay 1, the plan's only delay
    (``plan_segments``): row 0 takes row 1, row 1 takes z."""
    queue[0].copy_(queue[1])
    queue[1].copy_(z)


class _Phases:
    """The graph path of ``ZeroLatencyConvolver.process`` (the module's
    docstring): the tensors it owns, a pinned input and output, and one
    CUDA graph a cadence phase, all captured at once, in phase order, into
    one memory pool.

    Phase p's graph reads the state after phase p - 1 (``after[p - 1]``)
    and leaves the state after phase p (``after[p]``). The buffers, the
    queues and the IR spectra are the path's own tensors, written in place
    (the buffers are views of one tensor, which one index copy a phase
    writes). A firing's engine planes and the head's delay line are the
    tensors its step wrote, in the graphs' pool, held in ``after`` for the
    phases after it to read: no copy, but at the cycle's last phase, which
    writes its state into the tensors phase 0 reads (``static``). The pool
    is shared, so a phase's temporaries may lie where a phase captured
    after it holds a firing's output; that output is read by the phases
    after its own up to the cycle's last, and is dead when the earlier
    phase next runs, in the next cycle. So the replays keep their cyclic
    order from whichever phase they start at.

    ``capture`` False runs each phase's body eagerly in place of its graph
    (the same ops, on any device): what the CPU tests hold bit-equal to
    ``_step``."""

    def __init__(self, zl: "ZeroLatencyConvolver", capture: bool = True):
        self.zl, self.capture = zl, capture
        B, dev = zl.block, zl.device
        self.period = P = _period(zl.segments, B)
        last = zl.segments[-1] if zl.segments else None
        self.terminal = len(zl.segments) - 1 if last and last.nparts > 1 else None
        rs = [s.pts // B for s in zl.segments]
        fire = [[p % r == r - 1 for r in rs] for p in range(P)]
        self.fires = [sum(f) for f in fire]                    # firings a phase
        self.captured_fires = [sum(f[:self.terminal]) for f in fire]
        self.last_fires = [bool(f) and f[-1] for f in fire]
        self.warm = P               # eager callbacks before the captures
        self.graphs: List[Optional[torch.cuda.CUDAGraph]] = [None] * P
        self.captures = 0
        self.failed: Optional[str] = None
        self.static: Optional[ZLState] = None
        self.after: List[Optional[ZLState]] = [None] * P
        self.buf_rows: Optional[torch.Tensor] = None    # the buffers' one tensor, (rows, B)
        self.rows: Optional[torch.Tensor] = None        # (P, segments): the rows a phase writes
        self.term_eng: Optional[_p.PconvState] = None
        self.term_graph: Optional[_p.StepGraph] = None  # the terminal's, above pts 2048
        self.published: Optional[ZLState] = None
        pin = dev.type == "cuda"
        self.x_host = torch.zeros(B, dtype=torch.float32, pin_memory=pin)
        self.y_host = torch.zeros(B, dtype=torch.float32, pin_memory=pin)
        self.x_np, self.y_np = self.x_host.numpy(), self.y_host.numpy()
        self.x_dev = torch.zeros(B, dtype=torch.float32, device=dev)
        if capture:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(dev)
            self.done = torch.cuda.Event()

    def process(self, x: np.ndarray, on: bool) -> Optional[np.ndarray]:
        """Callback t = state.t by its phase's graph and the terminal
        firing; the output, a fresh array. None where the eager step is to
        serve it: in the first cycle, for a state off the cadence, once a
        capture has failed."""
        if self.failed is not None:
            return None
        if self.warm:
            self.warm -= 1
            return None
        state = self.zl.state
        if state is not self.published and not self._adopt(state):
            return None
        t = state.t
        p = t % self.period
        with profiling.request("zl", on):
            t0 = time.time_ns() if on else 0
            with profiling.span("replay") if on else _NULL:
                self.x_np[:] = x
                if self.capture:
                    self.graphs[p].replay()
                    self.done.record()
                else:
                    self.after[p] = self._body(p, self.after[p - 1])
                if self.terminal is not None and self.last_fires[p]:
                    self._fire_terminal()
            after = self.after[p]
            segs = after.segs
            if self.terminal is not None:
                segs = segs[:-1] + (segs[-1]._replace(eng=self.term_eng),)
            self.published = self.zl.state = after._replace(t=t + 1, segs=segs)
            if on:      # a body run eagerly has counted its firings' step.blocks
                replayed = int(self.capture)
                profiling.count(("zl.steps", 1), ("zl.replays", replayed),
                                ("zl.fires", self.fires[p]),
                                ("zl.terminal_fires", self.last_fires[p]),
                                ("step.blocks", replayed * self.captured_fires[p]),
                                ("zl.step_ns", time.time_ns() - t0))
                t0 = time.time_ns()
            with profiling.span("download") if on else _NULL:
                if self.capture:
                    self.done.synchronize()
                out = self.y_np.copy()
            if on:
                profiling.count(("zl.download_ns", time.time_ns() - t0))
        return out

    def _adopt(self, state: ZLState) -> bool:
        """Copy ``state`` into the tensors that its phase reads, in place;
        the first time, allocate them and capture the graphs. False where
        no phase's graph serves it (a head pointer off the cadence, a shape
        not the plan's) or the captures failed."""
        zl = self.zl
        if state.head.wp != state.t * zl.block % zl._head_cfg.ring:
            return False
        if self.static is None:
            self._allocate(state)
            if self.capture and not self._capture_all():
                return False
        pairs = list(zip(_owned(self.after[(state.t - 1) % self.period], self.terminal),
                         _owned(state, self.terminal)))
        if any(mine.shape != given.shape for mine, given in pairs):
            return False
        for mine, given in pairs:
            mine.copy_(given)
        if self.terminal is not None:
            self.term_eng = state.segs[self.terminal].eng
        self.published = state
        return True

    def _allocate(self, state: ZLState) -> None:
        """The path's own tensors, shaped as ``state``'s (the buffers views
        of one tensor of base-block rows); every phase reads them until
        the graphs are captured."""
        sizes = [st.buf.numel() for st in state.segs]
        flat = torch.empty(sum(sizes), dtype=torch.float32, device=self.zl.device)
        bufs = torch.split(flat, sizes)
        own = _own(state, self.terminal, torch.empty_like)
        self.static = own._replace(head=own.head._replace(wp=0), segs=tuple(
            st._replace(buf=buf) for st, buf in zip(own.segs, bufs)))
        self.after = [self.static] * self.period
        self.buf_rows = flat.view(-1, self.zl.block)
        rs = [size // self.zl.block for size in sizes]
        firsts = np.cumsum([0] + rs[:-1])       # each buffer's first row in buf_rows
        self.rows = torch.tensor([[int(f) + p % r for f, r in zip(firsts, rs)]
                                  for p in range(self.period)],
                                 dtype=torch.long, device=self.zl.device)

    def _body(self, p: int, state: ZLState) -> ZLState:
        """Phase p's callback from ``state`` (the state after phase p - 1):
        the input's copy from its pinned buffer, the head, every segment's
        accumulate (one index copy) and consume, the firings of all but the
        terminal segment, the output's copy into its pinned buffer. Returns
        the state after phase p; the cycle's last phase writes it into
        ``static``. The arithmetic and its order are ``_step``'s."""
        zl, B = self.zl, self.zl.block
        x = self.x_dev
        x.copy_(self.x_host, non_blocking=True)
        head, y = _d.dconv_step(zl._head_cfg, state.head, x)
        if zl.segments:
            self.buf_rows.index_copy_(0, self.rows[p], x.expand(len(zl.segments), B))
        segs = []
        for i, (s, cfg, st) in enumerate(zip(zl.segments, zl._seg_cfgs, state.segs)):
            r = s.pts // B
            m = p % r
            y.add_(st.queue[1, m * B:(m + 1) * B])
            if m == r - 1 and i != self.terminal:
                eng, z = _p.pconv_step(cfg, st.eng, st.buf)
                _push(st.queue, z)
                st = st._replace(eng=eng)
            segs.append(st)
        self.y_host.copy_(y, non_blocking=True)
        after = ZLState(t=state.t, head=head, segs=tuple(segs))
        if p < self.period - 1:
            return after
        for mine, new in zip(_owned(self.static, self.terminal), _owned(after, self.terminal)):
            if mine is not new:
                mine.copy_(new)
        return self.static

    def _fire_terminal(self) -> None:
        """The terminal segment's firing after the phase, on the path's
        buffer, its output into the path's queue: above pts 2048
        (``_mac_unpack_kernel``) its engine's step graph (``pconv.
        StepGraph``: the buffer its source, the queue's update its sink),
        else its engine's functional step, eagerly."""
        i = self.terminal
        st, cfg, dev = self.static.segs[i], self.zl._seg_cfgs[i], self.zl.device
        if not _p._mac_unpack_kernel(cfg, dev):
            self.term_eng, z = _p.pconv_step(cfg, self.term_eng, st.buf)
            _push(st.queue, z)
            return
        if self.term_graph is None:
            self.term_graph = _p.StepGraph(
                cfg, dev, False, source=st.buf, sink=functools.partial(_push, st.queue),
                on_message=lambda msg: self.zl.on_message(msg, self.zl.user_data))
        self.term_eng = self.term_graph.step(self.term_eng)

    def _capture_all(self) -> bool:
        """Capture every phase's body into its graph, in phase order, each
        from the state the one before it leaves; False, and the path off
        for good with the reason said once, if a capture fails."""
        here = torch.cuda.current_stream(self.zl.device)
        self.stream.wait_stream(here)
        state = self.static
        try:
            with torch.cuda.stream(self.stream):
                for p in range(self.period):
                    graph = torch.cuda.CUDAGraph()
                    graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                    try:
                        state = self._body(p, state)
                    finally:
                        graph.capture_end()
                    self.graphs[p], self.after[p] = graph, state
                    self.captures += 1
        except RuntimeError as e:
            self.failed = f"capture of phase {self.captures} failed: {e}"
            _p.settle_failed_capture(self.stream)
            self.graphs = [None] * self.period
            self.zl.on_message(f"zero-latency graph path off: {self.failed}", self.zl.user_data)
            return False
        finally:
            here.wait_stream(self.stream)
        return True
