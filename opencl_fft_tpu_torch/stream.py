"""Streaming "opcode" layer — parity with the Csound ``clconv`` plugin
(``csound/opcode.cpp:157-253``) for the partitioned engine (parts > 1).

Accumulates arbitrary-size audio blocks into partition-size engine calls
with one partition of latency (:240-249), zero-pads the IR to whole
partitions and applies the 0dbfs scale (:190-191) and table skip/size
(:181-182).
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from .api import Clpconv
from .utils.errors import ArgumentError
from .utils.logging import MessageCallback


class _BlockAccumulator:
    """The opcode layer's sample shuttle (opcode.cpp:240-249): accumulate
    arbitrary-size input blocks into `parts`-sample engine calls, emitting
    the previous engine output — exactly one partition of latency."""

    def __init__(self, parts: int, n_streams: int = 1):
        self.parts = parts
        self.cnt = 0
        self.bufin = np.zeros((n_streams, parts), np.float32)
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
    parts       — partition size (> 1; the direct (1) and zero-latency (0)
                  engines are not ported yet)
    skip, size  — optional IR table offset / length (opcode.cpp:181-182)
    scale       — 0dbfs multiplier applied to the IR (opcode.cpp:190-191)
    device      — None/"cuda" for card ``device_index``, or "cpu"
    """

    def __init__(self, ir: np.ndarray, parts: int, device_index: int = 0,
                 skip: int = 0, size: int = 0, scale: float = 1.0,
                 bin0_mode: str = "exact", impl: str = "auto",
                 on_message: Optional[MessageCallback] = None,
                 user_data: Any = None,
                 device: Optional[Union[str, torch.device]] = None):
        if parts == 1:
            raise NotImplementedError(
                "parts == 1 (direct engine) is not ported yet (ROADMAP queue 1 item 6)")
        if parts == 0:
            raise NotImplementedError(
                "parts == 0 (zero-latency engine) is not ported yet "
                "(ROADMAP queue 1 item 12)")
        ir = np.asarray(ir, np.float32).reshape(-1)
        length = (size if size else ir.size) - skip
        if length <= 0 or skip < 0 or skip + length > ir.size:
            raise ArgumentError(f"bad skip/size ({skip}/{size}) for IR of {ir.size}")
        coefs = ir[skip: skip + length] * np.float32(scale)
        self.parts = parts
        cvs = -(-length // parts) * parts          # pad IR to whole parts
        padded = np.zeros(cvs, np.float32)
        padded[:length] = coefs
        self._engine = Clpconv(device_index, cvs, parts, on_message, user_data,
                               bin0_mode=bin0_mode, impl=impl, device=device)
        if self._engine._exc is not None:
            raise self._engine._exc
        self._engine.push_ir(padded)
        self._acc = _BlockAccumulator(parts)

    @property
    def latency(self) -> int:
        """Samples of pipeline delay added by the block buffering."""
        return self.parts

    def set_ir(self, ir: np.ndarray, skip: int = 0, size: int = 0,
               scale: Optional[float] = None, fade_blocks: int = 8) -> None:
        raise NotImplementedError(
            "live IR replacement is not ported yet (ROADMAP queue 1 item 11)")

    def process(self, block: np.ndarray) -> np.ndarray:
        """One audio block in, one out (the aperf body, opcode.cpp:229-252)."""
        block = np.asarray(block, np.float32).reshape(-1)

        def run(bufin):
            out = np.empty(self.parts, np.float32)
            self._engine.convolution(out, bufin[0])
            return out

        return self._acc.feed(block[None, :], run)
