"""Csound engine binding — run the port's processors INSIDE a live
Csound performance (the JAX package's ``runtime/csound_host.py``).

The reference's L3 is four opcodes registered into Csound's engine as a
native plugin (`csnd::plugin<...>` in `on_load`, csound/opcode.cpp:347-352).
Python cannot register native opcodes through ctcsound (the Csound API
bindings), so the engine-resident equivalent is Csound's software bus: the
orchestra routes each opcode's operands to named audio channels, this host
pulls them every ksmps cycle, runs the matching `stream.py` processor (on
the card unless ``device="cpu"`` is passed through the insert's keywords),
and pushes the result back before the next cycle reads it. Same engine,
same ksmps block discipline, same one-partition latency and 0dbfs scaling —
the opcode *semantics* stay in `opencl_fft_tpu_torch.stream`; this module
is only the registration/transport layer.

The bus adds exactly one ksmps cycle of delay on top of the processor's
own latency (an instrument's `chnset` this cycle is visible to the host
after `performKsmps` returns; the host's answer is read by `chnget` next
cycle). `BusInsert.latency_blocks` records it so callers can align.

Import-guarded like `hosts.SoundDeviceHost`: constructing a
:class:`CsoundHost` without an importable `ctcsound` raises
``RuntimeError``; the signal path itself runs headlessly through the same
processors without an engine (the reference's clconv.csd workload).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

try:                                     # optional, like sounddevice
    import ctcsound                      # type: ignore
except Exception:                        # ImportError or binding load error
    ctcsound = None


@dataclass
class BusInsert:
    """One engine-resident processor insert.

    process      — callable mapping len(in_channels) ksmps-blocks to one
                   ksmps-block (e.g. ClconvProcessor.process or
                   CltvconvProcessor.process via a lambda)
    in_channels  — named audio channels the orchestra chnset's into
    out_channel  — named audio channel the orchestra chnget's from
    """
    process: Callable[..., np.ndarray]
    in_channels: Tuple[str, ...]
    out_channel: str
    latency_blocks: int = 1              # the bus round-trip (see module doc)
    _zeros: Optional[np.ndarray] = field(default=None, repr=False)


def clconv_insert(ir: np.ndarray, parts: int, *, block_size: int,
                  scale: float = 1.0, prefix: str = "clconv",
                  **kw) -> BusInsert:
    """`clconv` as a bus insert (reference opcode.cpp:157-253 semantics:
    IR from a table scaled by 0dbfs, parts==1 -> direct engine,
    one-partition latency)."""
    from ..stream import ClconvProcessor
    proc = ClconvProcessor(ir, parts, scale=scale, block_size=block_size,
                           **kw)
    return BusInsert(lambda a: proc.process(a),
                     (f"{prefix}_in",), f"{prefix}_out")


def cltvconv_insert(parts: int, size: int, *, block_size: int,
                    scale: float = 1.0, prefix: str = "cltvconv",
                    **kw) -> BusInsert:
    """`cltvconv` as a bus insert (reference opcode.cpp:255-345: both
    operands live, freeze controls via the processor's attributes)."""
    from ..stream import CltvconvProcessor
    proc = CltvconvProcessor(parts, size, scale=scale,
                             block_size=block_size, **kw)
    return BusInsert(lambda a, b: proc.process(a, b),
                     (f"{prefix}_in1", f"{prefix}_in2"), f"{prefix}_out")


class CsoundHost:
    """Drive a Csound performance with framework processors on the bus.

    Usage::

        host = CsoundHost(csd_text, [cltvconv_insert(2048, 16384,
                                                     block_size=64)])
        host.run()                      # blocks until the score ends

    The orchestra must route audio through the insert channels, e.g.::

        chnset ain1, "cltvconv_in1"
        chnset ain2, "cltvconv_in2"
        asig chnget:a("cltvconv_out")
    """

    def __init__(self, csd_text: str, inserts: Sequence[BusInsert],
                 options: Sequence[str] = ("-n",)):
        if ctcsound is None:
            raise RuntimeError(
                "ctcsound is not importable — install Csound + ctcsound "
                "to run engine-resident inserts (the signal path is "
                "otherwise available through opencl_fft_tpu_torch.stream)")
        self._cs = ctcsound.Csound()
        for opt in options:
            self._cs.setOption(opt)
        rc = self._cs.compileCsdText(csd_text)
        if rc != 0:
            raise RuntimeError(f"Csound failed to compile the CSD (rc={rc})")
        self.inserts = list(inserts)
        self.cycles = 0

    def run(self, max_cycles: Optional[int] = None) -> int:
        """Perform until the score ends (or max_cycles). Returns cycles."""
        cs = self._cs
        rc = cs.start()
        if rc != 0:
            raise RuntimeError(f"Csound failed to start (rc={rc})")
        ksmps = int(cs.ksmps())
        try:
            while True:
                if cs.performKsmps():
                    break                      # score finished
                for ins in self.inserts:
                    blocks = [np.asarray(cs.audioChannel(ch),
                                         np.float32)[:ksmps]
                              for ch in ins.in_channels]
                    out = np.asarray(ins.process(*blocks),
                                     np.float32).reshape(-1)
                    cs.setAudioChannel(ins.out_channel, out[:ksmps])
                self.cycles += 1
                if max_cycles is not None and self.cycles >= max_cycles:
                    break
        finally:
            cs.cleanup()
        return self.cycles

    def reset(self) -> None:
        self._cs.reset()


def available() -> bool:
    """True when a live Csound engine can be driven from this process."""
    return ctcsound is not None
