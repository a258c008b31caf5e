"""Convolution-reverb demo on the port: the reference's csound/clconv.csd
workload.

A synthesized source (a plucked arpeggio) runs through a synthetic hall IR
(1.5 s of exponentially decaying noise, 66,150 taps) in the streaming
``ClconvProcessor`` exactly as an audio host would feed it: fixed
ksmps = 64-sample blocks into partitions of 1024 samples, one partition of
latency. The processor's accumulator hands the engine whole partitions (one
block step on the card every 16 host blocks). Writes a .wav.

Run:  python -m opencl_fft_tpu_torch.examples.demo [out.wav] [--device cuda|cuda:i|cpu]
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..stream import ClconvProcessor
from ._common import SR, command_line, synth_hall_ir, synth_source, write_wav

PARTS = 1024
KSMPS = 64


def inputs() -> Tuple[np.ndarray, np.ndarray]:
    """(dry source, 1.5 s hall IR), made from seed 2024."""
    rng = np.random.default_rng(2024)
    dry = synth_source(rng)
    return dry, synth_hall_ir(1.5, rng)


def render(dry: np.ndarray, ir: np.ndarray, device=None, parts: int = PARTS,
           ksmps: int = KSMPS) -> np.ndarray:
    """The wet signal: dry and a tail of ir.size + parts zeros, streamed in
    ksmps-sample blocks through ``ClconvProcessor(ir, parts)`` on
    ``device`` (None: the card)."""
    proc = ClconvProcessor(ir, parts=parts, device=device)
    pad = np.zeros((-dry.size) % ksmps, np.float32)
    stream = np.concatenate([dry, pad, np.zeros(ir.size + parts, np.float32)])
    stream = stream[: stream.size - stream.size % ksmps]
    return np.concatenate([proc.process(stream[i: i + ksmps])
                           for i in range(0, stream.size, ksmps)])


def mix(dry: np.ndarray, wet: np.ndarray) -> np.ndarray:
    """0.7 dry + 0.6 wet, scaled down to peak 1 where it is louder."""
    m = 0.7 * np.pad(dry, (0, wet.size - dry.size)) + 0.6 * wet
    return m / max(1.0, np.max(np.abs(m)))


def main(argv: Optional[Sequence[str]] = None) -> int:
    args, dev = command_line(__doc__, [("out_path", str, "demo_reverb.wav")], argv)
    dry, ir = inputs()
    wet = render(dry, ir, dev)
    write_wav(args.out_path, mix(dry, wet))
    print(f"wrote {args.out_path}: {wet.size / SR:.1f}s, "
          f"IR {ir.size} taps, parts={PARTS}, ksmps={KSMPS}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
