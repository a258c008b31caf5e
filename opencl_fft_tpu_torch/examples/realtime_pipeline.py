"""Real-time pipeline demo on the port: audio callback, SPSC rings, device
worker.

The analog of running the reference's ``clconv`` opcode inside Csound's
real-time engine (csound/opcode.cpp:229-252), with the card's worker
decoupled from the audio thread by the native lock-free rings
(``runtime/stream_rt.cpp``), so that launches and copies never block the
callback.

Phase 1 measures the unpaced sustained throughput of the whole pipeline:
rings, worker and one engine step on the card a block, with its copies
(not a batched scan's throughput). Phase 2 runs a wall-clock-paced 48 kHz
duplex callback for a few seconds and reports underruns and overruns, the
real-time health metrics. Phase 3 puts the zero-added-latency engine behind
``ProcessorPipeline`` (``ClconvProcessor(parts=0)`` behind the same rings):
the stream then carries no algorithmic partition delay, only the priming.
It is paced only when its unpaced rate is at least 1.2x real time.

Run:  python -m opencl_fft_tpu_torch.examples.realtime_pipeline [pts] [seconds] [--device cuda|cuda:i|cpu]
      (defaults: pts=4096, 3 seconds, 2^17-tap IR). Exit code 1 when
      phase 2 underruns or overruns.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import pconv as P
from ..runtime.pipeline import ProcessorPipeline, RealtimePipeline
from ..stream import ClconvProcessor
from ._common import command_line

SR = 48000.0
IR_LEN = 1 << 17
PRIME = 4
BS3 = 2048            # phase 3's I/O granularity, not its latency
PMAX3 = 8192
BUDGET3 = 1.2         # phase 3 is paced only at this unpaced rate or more


def inputs(pts: int, seconds: float, ir_len: int = IR_LEN
           ) -> Tuple[P.PconvConfig, np.ndarray, np.ndarray, np.ndarray]:
    """(config, IR, phase 1-2 blocks (nblocks, pts), phase 3 blocks
    (nblk3, BS3)), made from seed 0: a decaying noise IR, noise blocks."""
    rng = np.random.default_rng(0)
    cfg = P.PconvConfig.for_ir_length(ir_len, pts)
    ir = (rng.standard_normal(ir_len) *
          np.exp(-np.arange(ir_len) / (0.3 * SR))).astype(np.float32)
    nblocks = max(64, int(seconds * SR / pts))
    blocks = rng.standard_normal((nblocks, pts)).astype(np.float32) * 0.1
    nblk3 = max(16, int(min(seconds, 1.5) * SR / BS3))
    blocks3 = rng.standard_normal((nblk3, BS3)).astype(np.float32) * 0.1
    return cfg, ir, blocks, blocks3


def unpaced(pipe, blocks: np.ndarray) -> Tuple[float, np.ndarray]:
    """Feed every block but the first (pushed and waited for before, to
    load the kernels off the clock) as fast as the rings take them, pulling
    what is ready. Returns (seconds, the pulled stream)."""
    n, bs = blocks.shape
    t0 = time.monotonic()
    fed, pulled = 1, []
    while pipe.blocks_processed < n:
        if fed < n:
            fed += int(pipe.push(blocks[fed]) > 0)
        if pipe.pull_available():
            pulled.append(pipe.pull(bs))
        time.sleep(1e-4)
    return time.monotonic() - t0, np.concatenate(pulled) if pulled else np.zeros(0, np.float32)


def paced(pipe, blocks: np.ndarray) -> np.ndarray:
    """One callback a block period from the second block on: push a block,
    pull a block. Returns the pulled stream."""
    n, bs = blocks.shape
    period = bs / SR
    nxt = time.monotonic()
    pulled = []
    for i in range(1, n):
        nxt += period
        while time.monotonic() < nxt:
            time.sleep(period / 100)
        pipe.push(blocks[i])
        pulled.append(pipe.pull(bs))
    return np.concatenate(pulled)


def warm(pipe, first: np.ndarray) -> None:
    """Process the first block (the kernels load off the clock)."""
    pipe.push(first)
    pipe.wait_for_blocks(1, timeout=600)


def phase1(cfg, ir, blocks, device=None) -> Dict[str, object]:
    """Unpaced ``RealtimePipeline``: its wall seconds, its rate (audio s a
    wall s) and the pulled stream (PRIME blocks of priming, then the step
    chain)."""
    with RealtimePipeline(cfg, ir=ir, prime_blocks=PRIME, capacity_blocks=16,
                          device=device) as pipe:
        warm(pipe, blocks[0])
        dt, out = unpaced(pipe, blocks)
    return {"seconds": dt, "rt": (len(blocks) - 1) * cfg.pts / SR / dt, "out": out}


def phase2(cfg, ir, blocks, device=None) -> Dict[str, object]:
    """``RealtimePipeline`` paced at 48 kHz: underruns, overruns, the
    output's peak and the pulled stream."""
    with RealtimePipeline(cfg, ir=ir, prime_blocks=PRIME, capacity_blocks=16,
                          device=device) as pipe:
        warm(pipe, blocks[0])
        out = paced(pipe, blocks)
    return {"underruns": pipe.underrun_samples, "overruns": pipe.overrun_samples,
            "peak": float(np.max(np.abs(out))), "out": out}


def phase3(ir, blocks3, device=None) -> Dict[str, object]:
    """The zero-latency processor behind ``ProcessorPipeline``: the unpaced
    rate, the unpaced pulled stream, the number of segments, and, when the
    rate is at least ``BUDGET3``, the underruns and overruns of a paced run
    on a fresh processor (else None)."""
    def processor():
        return ClconvProcessor(ir, parts=0, block_size=BS3, pmax=PMAX3, device=device)

    proc = processor()
    with ProcessorPipeline(proc, BS3, prime_blocks=PRIME, capacity_blocks=64) as pipe:
        warm(pipe, blocks3[0])
        dt, out = unpaced(pipe, blocks3)
    res = {"rt": (len(blocks3) - 1) * BS3 / SR / dt, "out": out,
           "segments": len(proc._engine.segments), "paced": None}
    if res["rt"] >= BUDGET3:
        with ProcessorPipeline(processor(), BS3, prime_blocks=PRIME,
                               capacity_blocks=64) as pipe:
            warm(pipe, blocks3[0])
            paced(pipe, blocks3)
        res["paced"] = (pipe.underrun_samples, pipe.overrun_samples)
    return res


def main(argv: Optional[Sequence[str]] = None) -> int:
    args, dev = command_line(__doc__, [("pts", int, 4096), ("seconds", float, 3.0)], argv)
    pts = args.pts
    cfg, ir, blocks, blocks3 = inputs(pts, args.seconds)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name} ({dev.type}); "
          f"pts={pts}, IR {IR_LEN} taps ({cfg.nparts} partitions)")

    r1 = phase1(cfg, ir, blocks, dev)
    print(f"phase 1 (unpaced): {len(blocks)} blocks in {r1['seconds']:.2f}s -> "
          f"{r1['rt']:.1f}x real time per-block round-trip")

    r2 = phase2(cfg, ir, blocks, dev)
    ok = r2["underruns"] == 0 and r2["overruns"] == 0
    print(f"phase 2 (paced @48kHz): {len(blocks) - 1} callbacks, "
          f"underruns={r2['underruns']} overruns={r2['overruns']} "
          f"peak={r2['peak']:.3f} -> {'REALTIME OK' if ok else 'NOT KEEPING UP'}")

    r3 = phase3(ir, blocks3, dev)
    fits = r3["rt"] >= BUDGET3
    print(f"phase 3 (zero-latency engine, {BS3}-sample blocks, "
          f"{r3['segments']} segments): algorithmic latency "
          f"0 samples (vs {pts} in phases 1-2), unpaced {r3['rt']:.2f}x real "
          f"time{'' if fits else ' — per-block sync floor of this'}"
          f"{'' if fits else ' host; throughput is phase 1'}")
    if fits:
        under3, over3 = r3["paced"]
        ok3 = under3 == 0 and over3 == 0
        print(f"phase 3 (paced @48kHz): {len(blocks3) - 1} callbacks, "
              f"underruns={under3} overruns={over3} -> "
              f"{'REALTIME OK' if ok3 else 'NOT KEEPING UP'}")
    else:
        print("phase 3 paced callback skipped: unpaced rate below the "
              f"{BUDGET3}x budget (per-block sync floor)")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
