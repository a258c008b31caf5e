"""Audio-host binding demo on the port: a PortAudio-convention callback
driving the convolution engine on the card (the analog of loading the
reference's opcodes into a live Csound engine, csound/opcode.cpp:347-352).

Opens the best available host: a real duplex sounddevice/PortAudio stream
when the package is installed and a sound card opens, else the
wall-clock-paced ``VirtualHost`` (the same callback contract). That is the
choice of an audio host, not of a compute device: the engine runs on the
card either way. A synthetic source runs through a 2^17-tap reverb for a few
seconds, and the demo reports the real-time health metrics (underruns,
overruns, late callbacks).

Run:  python -m opencl_fft_tpu_torch.examples.audio_host_demo [seconds] [pts] [--device cuda|cuda:i|cpu]
      (defaults: 3 seconds, pts=4096). Exit code 1 on underruns.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np

from ..ops import pconv as P
from ..runtime.hosts import PipelineCallback, VirtualHost, open_host
from ..runtime.pipeline import RealtimePipeline
from ._common import command_line

SR = 48000
IR_LEN = 1 << 17


def run(seconds: float = 3.0, pts: int = 4096, device=None, ir_len: int = IR_LEN,
        report=print) -> Dict[str, object]:
    """Play ``seconds`` of a 220 Hz melody through a ``RealtimePipeline``
    (an ir_len-tap decaying noise IR from seed 0, prime 4) on ``device``
    (None: the card), driven by ``open_host``'s host; ``report`` gets the
    host line before the run. Returns the host's kind and the counts."""
    rng = np.random.default_rng(0)
    cfg = P.PconvConfig.for_ir_length(ir_len, pts)
    ir = (rng.standard_normal(ir_len) *
          np.exp(-np.arange(ir_len) / (0.3 * SR))).astype(np.float32)

    t = np.arange(int(seconds * SR) + pts, dtype=np.float32) / SR
    melody = (0.3 * np.sin(2 * np.pi * 220 * t)
              * (0.5 + 0.5 * np.sin(2 * np.pi * 2.0 * t))).astype(np.float32)
    pos = [0]

    def source(n):
        s = melody[pos[0]:pos[0] + n]
        pos[0] += n
        return s if s.size == n else np.zeros(n, np.float32)

    with RealtimePipeline(cfg, ir=ir, prime_blocks=4, capacity_blocks=16,
                          device=device) as pipe:
        pipe.push(np.zeros(pts, np.float32))
        pipe.wait_for_blocks(1, timeout=600)    # the kernels load off the clock
        cb = PipelineCallback(pipe)
        host = open_host(cb, sr=SR, frames=pts, source=source)
        kind = type(host).__name__
        report(f"host: {kind}; pts={pts}, IR {ir_len} taps "
               f"({cfg.nparts} partitions), {seconds:.1f}s")
        with host:
            time.sleep(seconds)
    return {"host": kind, "callbacks": cb.callbacks, "underruns": pipe.underrun_samples,
            "overruns": pipe.overrun_samples,
            "late": host.late_callbacks if isinstance(host, VirtualHost) else None}


def main(argv: Optional[Sequence[str]] = None) -> int:
    args, dev = command_line(__doc__, [("seconds", float, 3.0), ("pts", int, 4096)], argv)
    res = run(args.seconds, args.pts, dev)
    print(f"callbacks: {res['callbacks']}; underrun samples: "
          f"{res['underruns']}; overrun samples: {res['overruns']}"
          + (f"; late callbacks: {res['late']}" if res["late"] is not None else ""))
    ok = res["underruns"] == 0
    print("REALTIME OK" if ok else "UNDERRUNS — raise prime_blocks "
          "or pts for this device")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
