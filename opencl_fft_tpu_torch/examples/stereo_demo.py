"""True-stereo convolution-reverb demo on the port (``MatrixConvolver``).

The reference is strictly 1-in 1-out (csound/opcode.cpp:157-253): a
true-stereo reverb there takes four ``clconv`` instances and manual mixing
in the orchestra. Here the whole 2-in, 2-out IR matrix (LL, LR, RL, RR)
runs as one batched scan of four channels on the card.

The source is the demo arpeggio panned across the stereo field; the IR
matrix is a synthetic hall whose direct paths (LL, RR) are bright and whose
cross paths (LR, RL) are delayed, darker bleed: the classic true-stereo
topology. Output is a stereo .wav.

Run:  python -m opencl_fft_tpu_torch.examples.stereo_demo [out.wav] [--device cuda|cuda:i|cpu]
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..models.convolver import MatrixConvolver
from ..ops import pconv as P
from ._common import SR, command_line, synth_hall_ir, synth_source, write_wav

PTS = 1024
IR_SECONDS = 1.5


def synth_stereo_source(rng) -> np.ndarray:
    """(2, T): the demo arpeggio auto-panned L to R and back."""
    mono = synth_source(rng)
    t = np.arange(mono.size, dtype=np.float32) / SR
    pan = 0.5 * (1.0 + np.sin(2.0 * np.pi * 0.25 * t))  # 0..1, 4 s period
    return np.stack([mono * np.sqrt(1.0 - pan), mono * np.sqrt(pan)])


def synth_ir_matrix(seconds: float, cvs: int, rng) -> np.ndarray:
    """(2, 2, cvs) hall matrix: direct LL/RR and delayed, darker LR/RL."""
    irs = np.zeros((2, 2, cvs), np.float32)
    for o in range(2):
        direct = synth_hall_ir(seconds, rng)
        n = min(direct.size, cvs)
        irs[o, o, :n] = direct[:n]
        # cross-bleed: 11 ms early-reflection delay, -9 dB, one-pole lowpass
        bleed = synth_hall_ir(seconds * 0.8, rng)
        for i in range(1, bleed.size):
            bleed[i] += 0.6 * (bleed[i - 1] - bleed[i])
        d = int(0.011 * SR)
        m = min(bleed.size, cvs - d)
        irs[o, 1 - o, d:d + m] = 0.35 * bleed[:m]
    return irs


def inputs(ir_seconds: float = IR_SECONDS, pts: int = PTS
           ) -> Tuple[np.ndarray, P.PconvConfig, np.ndarray]:
    """(dry (2, T), the engine's config, the IR matrix (2, 2, cvs)), made
    from seed 2024; the IR rounded up to whole partitions."""
    rng = np.random.default_rng(2024)
    dry = synth_stereo_source(rng)
    ir_len = int(SR * ir_seconds)
    ir_len += (-ir_len) % pts
    cfg = P.PconvConfig.for_ir_length(ir_len, pts)
    return dry, cfg, synth_ir_matrix(ir_seconds, cfg.cvs, rng)


def render(dry: np.ndarray, cfg: P.PconvConfig, irs: np.ndarray,
           device=None) -> Tuple[np.ndarray, np.ndarray]:
    """(the stream (2, T) fed in, the wet output (2, T)): dry and a tail of
    cvs + pts zeros, rounded up to whole blocks, as one (nblk, 2, pts) scan
    of ``MatrixConvolver(cfg, 2, 2)`` on ``device`` (None: the card)."""
    pts = cfg.pts
    conv = MatrixConvolver(cfg, n_in=2, n_out=2, device=device)
    conv.push_ir(irs)
    T = dry.shape[1] + cfg.cvs + pts
    T += (-T) % pts           # round up: keep the full reverb decay
    stream = np.zeros((2, T), np.float32)
    stream[:, : dry.shape[1]] = dry
    blocks = stream.reshape(2, -1, pts).transpose(1, 0, 2)  # (nblk, 2, pts)
    wet = conv.stream(blocks).cpu().numpy()                 # (nblk, 2, pts)
    return stream, wet.transpose(1, 0, 2).reshape(2, -1)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args, dev = command_line(__doc__, [("out_path", str, "stereo_reverb.wav")], argv)
    dry, cfg, irs = inputs()
    stream, wet = render(dry, cfg, irs, dev)
    mix = 0.7 * stream + 0.6 * wet
    write_wav(args.out_path, mix / max(1.0, np.max(np.abs(mix))))
    print(f"wrote {args.out_path}: stereo, {wet.shape[1] / SR:.1f}s, "
          f"4-IR matrix ({cfg.cvs} taps each), parts={PTS}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
