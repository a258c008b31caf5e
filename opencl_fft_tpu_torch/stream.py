"""Streaming "opcode" layer — parity with the four Csound plugins: ``clfft``
and ``clrfft`` (``csound/opcode.cpp:43-153``), and ``clconv`` and
``cltvconv`` (``:157-345``) for the partitioned (parts > 1) and direct
(parts == 1) engines.

The FFT processors round the transform size up to a power of two (``np2``,
:30-35), zero-pad the input and truncate the output back to the k-array's
length.

The partitioned engines accumulate arbitrary-size audio blocks into
partition-size engine calls with one partition of latency (:240-249); the
direct engine runs fixed-size blocks with none, and so does the
zero-latency engine (``parts=0``, beyond the reference:
``models/lowlatency.ZeroLatencyConvolver``). ``ClconvProcessor``
zero-pads the IR to whole partitions and applies the 0dbfs scale (:190-191)
and table skip/size (:181-182). The partitioned processors shuttle samples
through ``make_accumulator``: the native C++ accumulator of ``runtime/``.

A callback that cannot fill the partition, on 1-D float32 arrays of one
length, takes ``_accumulate``: numpy slice operations on the accumulator's
buffers, no copy of its arguments and no call into the native runtime;
every other callback takes ``_feed``.

While a torch profiler records (``utils.profiling.enabled``, asked once a
callback), the partitioned processors count their callbacks and time those
that fire no block (``_accumulate``, ``_feed``), and each firing is a
``fire`` request of ``utils.profiling`` with the engine's stages inside;
the zero-latency engine is handed the answer and records its own (``zl``).
"""

from __future__ import annotations

import time
from typing import Any, Optional, Union

import numpy as np
import torch

from .api import Clcfft, Cldconv, Clpconv, Clrfft
from .models.lowlatency import ZeroLatencyConvolver
from .utils import profiling
from .utils.devices import get_device
from .utils.errors import ArgumentError
from .utils.logging import MessageCallback, resolve_callback
from .utils.numerics import np2

Device = Optional[Union[str, torch.device]]


class ClfftProcessor:
    """k-rate complex FFT on arrays (the `clfft` opcode, opcode.cpp:43-97).

    The transform size is the input length rounded up to a power of two
    (np2, opcode.cpp:64); shorter inputs are zero-padded and the output is
    truncated back to the input length, matching the opcode's fixed-length
    k-array in/out contract. device — None/"cuda" for card
    ``device_index``, or "cpu".
    """

    def __init__(self, length: int, fwd: bool = True, device_index: int = 0,
                 impl: str = "auto",
                 on_message: Optional[MessageCallback] = None,
                 user_data: Any = None, device: Device = None):
        self.length = length           # complex points in the k-array
        self.n = np2(length)
        self._fft = Clcfft(device_index, self.n, fwd, impl, on_message, user_data,
                           device)

    def process(self, data: np.ndarray) -> np.ndarray:
        data = np.asarray(data, dtype=np.complex64).reshape(-1)
        if data.size != self.length:
            raise ArgumentError(
                f"expected {self.length} complex values, got {data.size}")
        buf = np.zeros(self.n, np.complex64)
        buf[: self.length] = data
        self._fft.transform(buf)
        return buf[: self.length]


class ClrfftProcessor:
    """k-rate real FFT (the `clrfft` opcode, opcode.cpp:99-153).

    length counts REAL samples; forward output is length/2 packed complex
    bins (padded internally to np2(length)). device — None/"cuda" for card
    ``device_index``, or "cpu"."""

    def __init__(self, length: int, fwd: bool = True, device_index: int = 0,
                 impl: str = "auto",
                 on_message: Optional[MessageCallback] = None,
                 user_data: Any = None, device: Device = None):
        self.length = length
        self.n = np2(length)
        self.fwd = bool(fwd)
        self._fft = Clrfft(device_index, self.n, fwd, impl, on_message, user_data,
                           device)

    def process(self, data: np.ndarray) -> np.ndarray:
        if self.fwd:
            r = np.zeros(self.n, np.float32)
            r[: self.length] = np.asarray(data, np.float32).reshape(-1)
            c = np.zeros(self.n // 2, np.complex64)
            self._fft.transform(c, r)
            return c[: self.length // 2]
        c = np.zeros(self.n // 2, np.complex64)
        src = np.asarray(data, np.complex64).reshape(-1)
        c[: src.size] = src
        r = np.zeros(self.n, np.float32)
        self._fft.transform(c, r)
        return r[: self.length]


def make_accumulator(parts: int, n_streams: int = 1, native: bool = True):
    """Block accumulator factory (JAX ``stream.py:94-105``): the C++
    runtime (``runtime/stream_rt.cpp``) when ``native``, else the numpy
    implementation below; both have the same semantics (held equal in
    ``tests/test_torch_runtime.py``). The numpy one is also taken when no
    ``g++`` is on PATH to build the runtime; a failed build raises."""
    if native:
        from .runtime import NativeBlockAccumulator, native_available
        if native_available():
            return NativeBlockAccumulator(parts, n_streams)
    return _BlockAccumulator(parts, n_streams)


_F32 = np.dtype(np.float32)


def _accumulate(acc, ins: tuple, keep: tuple, on: bool, t0: int,
                scale: Optional[np.float32] = None) -> Optional[np.ndarray]:
    """The callback that cannot fill the partition (``acc.cnt + k <
    acc.parts``) on ``ins``, 1-D float32 ndarrays of one length ``k``;
    None, having done nothing, for any other. Writes each operand whose
    ``keep`` is set into its row of ``acc.bufin`` (``acc.rows``) at the
    count, divided by ``scale`` if given (a frozen operand's slice already
    holds what the accumulator would write back); returns a copy of
    ``acc.bufout`` there, times ``scale`` (never a view: the next firing
    overwrites it); advances the count. That is ``_feed``'s result bit for
    bit; a scale of 1 is passed as None (x / 1 and x * 1 are x). With
    tracing ``on`` it counts as ``_feed`` counts a callback that fires no
    block, and in ``process.direct_callbacks``."""
    x = ins[0]
    if type(x) is not np.ndarray or x.ndim != 1:
        return None
    shape = x.shape
    cnt = acc.cnt
    end = cnt + shape[0]
    if end >= acc.parts:
        return None
    for y in ins:
        if type(y) is not np.ndarray or y.dtype is not _F32 or y.shape != shape:
            return None
    t1 = time.time_ns() if on else 0
    for row, y, k in zip(acc.rows, ins, keep):
        if k:
            if scale is None:
                row[cnt:end] = y
            else:
                np.divide(y, scale, out=row[cnt:end])
    out = acc.bufout[cnt:end]
    out = out.copy() if scale is None else out * scale
    acc.cnt = end
    if on:
        t2 = time.time_ns()
        profiling.count(("process.callbacks", 1), ("process.accumulate_callbacks", 1),
                        ("process.direct_callbacks", 1), ("process.accumulate_ns", t2 - t0),
                        ("feed.accumulate_ns", t2 - t1))
    return out


def _feed(acc, blocks: np.ndarray, run_engine, on: bool, t0: int,
          scale: Optional[np.float32] = None) -> np.ndarray:
    """``acc.feed(blocks, run_engine)`` (times ``scale`` if given): a
    partitioned processor's callback after its argument handling. With
    tracing ``on`` (the callback's ``profiling.enabled()``; ``t0`` its
    entry by ``time.time_ns()``) the callback counts in ``process.callbacks``
    and, if it fires no block, in ``process.accumulate_callbacks``, its host
    ns from entry to return in ``process.accumulate_ns`` and the
    accumulator's in ``feed.accumulate_ns``."""
    if not on:
        out = acc.feed(blocks, run_engine)
        return out if scale is None else out * scale
    t1 = time.time_ns()
    out = acc.feed(blocks, run_engine)
    t2 = time.time_ns()
    if scale is not None:
        out = out * scale
    t3 = time.time_ns()
    if acc.cnt >= blocks.shape[-1]:          # no block fired: the count only grew
        profiling.count(("process.callbacks", 1), ("process.accumulate_callbacks", 1),
                        ("process.accumulate_ns", t3 - t0), ("feed.accumulate_ns", t2 - t1))
    else:
        profiling.count(("process.callbacks", 1))
    return out


class _BlockAccumulator:
    """The opcode layer's sample shuttle (opcode.cpp:240-249): accumulate
    arbitrary-size input blocks into `parts`-sample engine calls, emitting
    the previous engine output — exactly one partition of latency."""

    def __init__(self, parts: int, n_streams: int = 1):
        self.parts = parts
        self.cnt = 0
        self.bufin = np.zeros((n_streams, parts), np.float32)
        self.rows = tuple(self.bufin)      # views of bufin's rows, bound once
        self.bufout = np.zeros(parts, np.float32)

    def feed(self, blocks: np.ndarray, run_engine) -> np.ndarray:
        """blocks: (n_streams, k) arbitrary k. Returns (k,) output.
        run_engine(bufin (n_streams, parts)) -> (parts,) output."""
        k = blocks.shape[-1]
        out = np.empty(k, np.float32)
        pos = 0
        while pos < k:
            take = min(self.parts - self.cnt, k - pos)
            sl = slice(self.cnt, self.cnt + take)
            out[pos: pos + take] = self.bufout[sl]
            self.bufin[:, sl] = blocks[:, pos: pos + take]
            self.cnt += take
            pos += take
            if self.cnt == self.parts:
                self.bufout = np.asarray(run_engine(self.bufin), np.float32)
                self.cnt = 0
        return out


class ClconvProcessor:
    """Streaming LTI convolution (the `clconv` opcode, opcode.cpp:157-253).

    ir          — impulse response samples (the function-table contents)
    parts       — partition size (> 1); 1 selects the direct engine and 0
                  (beyond the reference) the zero-added-latency non-uniform
                  engine (models/lowlatency.py): block_size-sample blocks in
                  and out, ``latency`` == 0, which the reference cannot do
                  (opcode.cpp:240-249 reads the previous block)
    skip, size  — optional IR table offset / length (opcode.cpp:181-182)
    scale       — 0dbfs multiplier applied to the IR (opcode.cpp:190-191)
    block_size  — direct and zero-latency engines: their fixed block size
    pmax        — zero-latency engine only: the largest partition of its
                  plan (clamped to >= block_size)
    device      — None/"cuda" for card ``device_index``, or "cpu"
    """

    def __init__(self, ir: np.ndarray, parts: int, device_index: int = 0,
                 skip: int = 0, size: int = 0, scale: float = 1.0,
                 block_size: int = 64, bin0_mode: str = "exact",
                 impl: str = "auto", pmax: int = 1024,
                 on_message: Optional[MessageCallback] = None,
                 user_data: Any = None,
                 device: Optional[Union[str, torch.device]] = None):
        ir = np.asarray(ir, np.float32).reshape(-1)
        length = (size if size else ir.size) - skip
        if length <= 0 or skip < 0 or skip + length > ir.size:
            raise ArgumentError(f"bad skip/size ({skip}/{size}) for IR of {ir.size}")
        coefs = ir[skip: skip + length] * np.float32(scale)
        self.parts = parts
        self._ir_scale = np.float32(scale)
        self.dconv = parts == 1
        self.zero_latency = parts == 0
        if self.zero_latency:
            self.block_size = block_size
            dev = get_device(device_index, device, on_message, user_data)
            try:
                self._engine = ZeroLatencyConvolver(
                    coefs, block=block_size, pmax=max(pmax, block_size), impl=impl, device=dev)
            except ValueError as e:   # plan validation speaks this surface's dialect
                raise ArgumentError(str(e)) from e
            self._engine.on_message = resolve_callback(on_message)
            self._engine.user_data = user_data
            return
        if self.dconv:
            self.block_size = block_size
            self._engine = _engine(Cldconv(device_index, length, block_size,
                                           on_message, user_data, device=device))
            self._engine.push_ir(coefs)
            return
        cvs = -(-length // parts) * parts          # pad IR to whole parts
        padded = np.zeros(cvs, np.float32)
        padded[:length] = coefs
        self._engine = _engine(Clpconv(device_index, cvs, parts, on_message, user_data,
                                       bin0_mode=bin0_mode, impl=impl, device=device))
        self._engine.push_ir(padded)
        self._acc = make_accumulator(parts)

    @property
    def latency(self) -> int:
        """Samples of pipeline delay added by the block buffering."""
        return 0 if (self.dconv or self.zero_latency) else self.parts

    def set_ir(self, ir: np.ndarray, skip: int = 0, size: int = 0,
               scale: Optional[float] = None, fade_blocks: int = 8) -> None:
        """Replace the impulse response on the live stream (beyond the
        reference, which would tear the opcode down and build it again;
        partitioned engine only; JAX ``stream.py:200-233``).

        The same skip/size/scale preparation as the constructor (scale
        defaults to the constructor's); the prepared IR must fit the
        engine's analysis size and is zero-padded up to it. ``fade_blocks``
        partition blocks of per-sample crossfade make the swap click-free
        (``Clpconv.push_ir_xfade``); ``fade_blocks=0`` swaps at once (push_ir
        semantics, cl_conv.cpp:353-388).
        """
        if self.dconv or self.zero_latency:
            raise ArgumentError("set_ir requires the partitioned engine (parts > 1)")
        ir = np.asarray(ir, np.float32).reshape(-1)
        length = (size if size else ir.size) - skip
        if length <= 0 or skip < 0 or skip + length > ir.size:
            raise ArgumentError(f"bad skip/size ({skip}/{size}) for IR of {ir.size}")
        if scale is None:
            scale = self._ir_scale
        cvs = self._engine.cfg.cvs
        if length > cvs:
            raise ArgumentError(
                f"new IR ({length} taps after skip/size) exceeds the engine's analysis "
                f"size ({cvs}); construct a new processor")
        padded = np.zeros(cvs, np.float32)
        padded[:length] = ir[skip: skip + length] * np.float32(scale)
        if fade_blocks:
            self._engine.push_ir_xfade(padded, fade_blocks)
        else:
            self._engine.push_ir(padded)

    def process(self, block: np.ndarray) -> np.ndarray:
        """One audio block in, one out (the aperf body, opcode.cpp:229-252)."""
        on = profiling.enabled()
        t0 = time.time_ns() if on else 0
        if not (self.dconv or self.zero_latency):
            out = _accumulate(self._acc, (block,), (True,), on, t0)
            if out is not None:
                return out
        block = np.asarray(block, np.float32).reshape(-1)
        if self.zero_latency:
            if block.size != self.block_size:
                raise ArgumentError(
                    f"zero-latency engine is fixed at {self.block_size}-sample blocks")
            return self._engine.process(block, on)
        if self.dconv:
            if block.size != self.block_size:
                raise ArgumentError(
                    f"direct engine is fixed at {self.block_size}-sample blocks")
            out = np.empty(self.block_size, np.float32)
            self._engine.convolution(out, block)
            return out

        def run(bufin):
            out = np.empty(self.parts, np.float32)
            with profiling.request("fire", on):
                self._engine.convolution(out, bufin[0])
            return out

        return _feed(self._acc, block[None, :], run, on, t0)


class CltvconvProcessor:
    """Streaming time-varying convolution (`cltvconv`, opcode.cpp:255-345).

    Both operands are live signals; freeze1/freeze2 gate updates of each
    operand's buffer (True = keep updating, the reference polarity; the
    reference wires both to the same control, quirk Q5). scale is the 0dbfs
    value: inputs are divided by it before buffering and outputs multiplied
    back (opcode.cpp:322-334).

    parts — partition size (> 1), or 1 for the direct engine
    size  — convolution size in samples (a multiple of parts)
    block_size — direct engine only: its fixed block size
    device — None/"cuda" for card ``device_index``, or "cpu"
    """

    def __init__(self, parts: int, size: int, device_index: int = 0,
                 scale: float = 1.0, block_size: int = 64,
                 bin0_mode: str = "exact", impl: str = "auto",
                 on_message: Optional[MessageCallback] = None,
                 user_data: Any = None,
                 device: Optional[Union[str, torch.device]] = None):
        if parts < 1:
            raise ArgumentError(f"parts must be >= 1, got {parts}")
        self.parts = parts
        self.scale = np.float32(scale)
        self.freeze1 = True        # True = keep updating (reference polarity)
        self.freeze2 = True
        self.dconv = parts == 1
        if self.dconv:
            self.block_size = block_size
            self._engine = _engine(Cldconv(device_index, size, block_size,
                                           on_message, user_data, device=device))
            self._bufin = np.zeros((2, block_size), np.float32)
        else:
            if size % parts:
                raise ArgumentError(
                    f"conv size {size} must be a multiple of parts {parts}")
            self._engine = _engine(Clpconv(device_index, size, parts, on_message,
                                           user_data, bin0_mode=bin0_mode, impl=impl,
                                           device=device))
            self._acc = make_accumulator(parts, n_streams=2)

    def process(self, in1: np.ndarray, in2: np.ndarray,
                freeze1: Optional[bool] = None,
                freeze2: Optional[bool] = None) -> np.ndarray:
        """One audio block of both operands -> one output block."""
        on = profiling.enabled()
        t0 = time.time_ns() if on else 0
        if freeze1 is not None:
            self.freeze1 = bool(freeze1)
        if freeze2 is not None:
            self.freeze2 = bool(freeze2)
        if not self.dconv:
            scale = self.scale
            out = _accumulate(self._acc, (in1, in2), (self.freeze1, self.freeze2), on, t0,
                              None if scale == 1 else scale)
            if out is not None:
                return out
        a = np.asarray(in1, np.float32).reshape(-1) / self.scale
        b = np.asarray(in2, np.float32).reshape(-1) / self.scale
        if self.dconv:
            if a.size != self.block_size:
                raise ArgumentError(
                    f"direct engine is fixed at {self.block_size}-sample blocks")
            if self.freeze1:
                self._bufin[0] = a
            if self.freeze2:
                self._bufin[1] = b
            out = np.empty(self.block_size, np.float32)
            self._engine.convolution(out, self._bufin[0], self._bufin[1])
            return out * self.scale

        def run(bufin):
            out = np.empty(self.parts, np.float32)
            with profiling.request("fire", on):
                self._engine.convolution(out, bufin[0], bufin[1])
            return out

        # freeze: a frozen operand's buffer keeps its previous contents —
        # feed it its own current values back (opcode.cpp:332-333 semantics)
        k = a.shape[-1]
        idx = (self._acc.cnt + np.arange(k)) % self.parts
        blocks = np.empty((2, k), np.float32)
        blocks[0] = a if self.freeze1 else self._acc.bufin[0][idx]
        blocks[1] = b if self.freeze2 else self._acc.bufin[1][idx]
        return _feed(self._acc, blocks, run, on, t0, self.scale)


def _engine(engine):
    """The engine, or the exception its constructor recorded."""
    if engine._exc is not None:
        raise engine._exc
    return engine
