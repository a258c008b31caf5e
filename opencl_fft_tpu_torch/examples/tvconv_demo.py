"""Time-varying convolution demo on the port: the ``cltvconv`` use-case.

Cross-synthesizes two live signals (the reference's time-varying
convolution, where the "impulse response" is itself an audio stream,
csound/README.md:6-11): a rhythmic noise-burst pattern convolved with an
evolving harmonic drone, in ``CltvconvProcessor(512, 4096)`` fed 256-sample
blocks for 6 s. The drone's buffer is frozen (freeze2) from 2 s to 4 s to
hold a spectral snapshot, as the opcode's freeze controls are played.

Run:  python -m opencl_fft_tpu_torch.examples.tvconv_demo [out.wav] [--device cuda|cuda:i|cpu]
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..stream import CltvconvProcessor
from ._common import SR, command_line, drone, noise_bursts, write_wav

PARTS = 512
SIZE = 512 * 8
BLOCK = 256
FROZEN = (2.0, 4.0)       # seconds in which the drone's buffer is frozen


def inputs(dur: float = 6.0) -> Tuple[np.ndarray, np.ndarray]:
    """(noise bursts, drone) of ``dur`` seconds, made from seed 7."""
    rng = np.random.default_rng(7)
    total = int(SR * dur)
    return noise_bursts(total, rng), drone(total)


def render(a: np.ndarray, b: np.ndarray, device=None,
           frozen: Tuple[float, float] = FROZEN) -> np.ndarray:
    """a convolved with the live b in ``BLOCK``-sample blocks through
    ``CltvconvProcessor(PARTS, SIZE)`` on ``device`` (None: the card), b's
    buffer frozen for block starts strictly inside ``frozen`` seconds."""
    tv = CltvconvProcessor(PARTS, SIZE, device=device)
    outs = []
    for i in range(a.size // BLOCK):
        t = i * BLOCK / SR
        sl = slice(i * BLOCK, (i + 1) * BLOCK)
        outs.append(tv.process(a[sl], b[sl], freeze2=not (frozen[0] < t < frozen[1])))
    return np.concatenate(outs)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args, dev = command_line(__doc__, [("out_path", str, "tvconv_demo.wav")], argv)
    dur = 6.0
    wet = render(*inputs(dur), dev)
    write_wav(args.out_path, 0.8 * wet / max(1e-9, np.max(np.abs(wet))))
    print(f"wrote {args.out_path}: {dur:.0f}s cross-synthesis, "
          f"parts={PARTS}, conv size={SIZE}, freeze2 gated at 2-4s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
