"""Zero-added-latency convolution demo on the port.

Runs the reverb workload of ``demo`` through ``ZeroLatencyConvolver``
(non-uniform Gardner partitioning: a direct-FIR head and doubling partition
sizes) and checks its defining property live: the streamed output is
sample-aligned with the offline convolution, where the reference's
streaming layer always pays one full partition of latency
(csound/opcode.cpp:240-249).

The demo measures the alignment: it streams a unit impulse and locates the
IR's onset in the output, and prints the added latency in samples of the
zero-latency engine (expected: 0) and of the uniform one-partition engine
it replaces (expected: parts).

Run:  python -m opencl_fft_tpu_torch.examples.zl_demo [out.wav] [--device cuda|cuda:i|cpu]
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..models.lowlatency import Segment, ZeroLatencyConvolver
from ..stream import ClconvProcessor
from ._common import SR, command_line, write_wav
from .demo import inputs, mix

BLOCK = 64
PARTS = 1024        # the uniform engine of the latency comparison


def measured_latency(process, block: int, ir: np.ndarray, nblocks: int = 40) -> int:
    """Stream a unit impulse; return onset(output) - onset(ir)."""
    onset_ir = int(np.argmax(np.abs(ir) > 1e-6))
    out = []
    for b in range(nblocks):
        x = np.zeros(block, np.float32)
        if b == 0:
            x[0] = 1.0
        out.append(np.asarray(process(x)))
    y = np.concatenate(out)
    onset_y = int(np.argmax(np.abs(y) > 1e-6))
    return onset_y - onset_ir


def latencies(ir: np.ndarray, device=None, block: int = BLOCK,
              parts: int = PARTS) -> Tuple[int, int]:
    """(zero-latency engine, uniform parts engine) added latency in samples,
    each on a fresh engine on ``device`` (None: the card)."""
    zl = ZeroLatencyConvolver(ir, block=block, device=device)
    uni = ClconvProcessor(ir, parts=parts, device=device)
    return measured_latency(zl.process, block, ir), measured_latency(uni.process, block, ir)


def render(dry: np.ndarray, ir: np.ndarray, device=None, block: int = BLOCK
           ) -> Tuple[np.ndarray, List[Segment]]:
    """(wet, the engine's segments): dry and a tail of ir.size + 1024 zeros
    streamed block by block, like an audio host, through
    ``ZeroLatencyConvolver(ir, block)`` on ``device`` (None: the card)."""
    zl = ZeroLatencyConvolver(ir, block=block, device=device)
    pad = np.zeros((-dry.size) % block, np.float32)
    stream = np.concatenate([dry, pad, np.zeros(ir.size + 1024, np.float32)])
    stream = stream[: stream.size - stream.size % block]
    wet = np.concatenate([zl.process(stream[i: i + block])
                          for i in range(0, stream.size, block)])
    return wet, zl.segments


def main(argv: Optional[Sequence[str]] = None) -> int:
    args, dev = command_line(__doc__, [("out_path", str, "zl_demo.wav")], argv)
    dry, ir = inputs()
    lat_zl, lat_uni = latencies(ir, dev)
    print(f"measured added latency: zero-latency engine = {lat_zl} samples, "
          f"uniform parts={PARTS} engine = {lat_uni} samples")
    if lat_zl != 0:
        raise AssertionError(f"zero-latency engine added {lat_zl} samples")

    wet, segments = render(dry, ir, dev)
    write_wav(args.out_path, mix(dry, wet))
    print(f"wrote {args.out_path}: {wet.size / SR:.1f}s, IR {ir.size} taps, "
          f"block={BLOCK}, head+{len(segments)} segments "
          f"(pts {[s.pts for s in segments]})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
