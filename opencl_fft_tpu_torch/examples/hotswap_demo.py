"""IR hot-swap demo on the port: changing rooms on a live stream without a
click.

Plays the synthesized arpeggio through the streaming convolution reverb and
replaces the impulse response mid-phrase: once instantly (the reference's
push_ir semantics, cl_conv.cpp:353-388: audible as a discontinuity) and
once through the crossfaded hot-swap (``ClconvProcessor.set_ir`` with
``fade_blocks=8``), which blends the two exact convolutions sample by
sample. Writes both renders to one A/B .wav (instant swap first, half a
second of silence, then the faded swap) and prints the largest
sample-to-sample jump around each swap point, the objective "click"
measure.

Run:  python -m opencl_fft_tpu_torch.examples.hotswap_demo [out.wav] [--device cuda|cuda:i|cpu]
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..stream import ClconvProcessor
from ._common import SR, command_line, synth_hall_ir, synth_source, write_wav

PARTS = 1024
FADE = 8


def inputs() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(dry source, a tight 0.4 s room, a long bright 1.8 s hall), from
    seeds 7 and 8: the two rooms differ as much as they can, so that an
    instant swap clicks."""
    rng = np.random.default_rng(7)
    dry = synth_source(rng)
    small = synth_hall_ir(0.4, rng)
    big = synth_hall_ir(1.8, np.random.default_rng(8)) * 1.4
    return dry, small, big


def render(dry: np.ndarray, ir_a: np.ndarray, ir_b: np.ndarray, parts: int,
           swap_block: int, fade_blocks: int, device=None) -> np.ndarray:
    """Stream dry through reverb A, swapping to B at swap_block, on
    ``device`` (None: the card)."""
    # the analysis size is fixed at construction: size the engine for the
    # longest IR it will ever hold (shorter ones zero-pad)
    maxlen = max(ir_a.size, ir_b.size)
    ir_a = np.pad(np.asarray(ir_a, np.float32), (0, maxlen - ir_a.size))
    proc = ClconvProcessor(ir_a, parts=parts, device=device)
    tail = np.zeros(maxlen + parts, np.float32)
    stream = np.concatenate([dry, tail])
    stream = stream[: stream.size - stream.size % parts]
    out = []
    for i in range(stream.size // parts):
        if i == swap_block:
            proc.set_ir(ir_b, fade_blocks=fade_blocks)
        out.append(proc.process(stream[i * parts: (i + 1) * parts]))
    return np.concatenate(out)


def max_jump(x: np.ndarray, lo: int, hi: int) -> float:
    """Largest sample-to-sample step in x[lo:hi] (the click metric)."""
    return float(np.max(np.abs(np.diff(x[lo:hi]))))


def jumps(instant: np.ndarray, faded: np.ndarray, parts: int,
          swap_block: int) -> Tuple[float, float, float]:
    """(instant, faded, baseline) click metrics: the largest step within
    half a partition of the swap onset (the output lags one partition), and
    the larger of the two renders' steps in a window far from the swap."""
    s0 = (swap_block + 1) * parts
    w = parts // 2
    base = max(max_jump(instant, s0 - 8 * parts, s0 - 7 * parts),
               max_jump(faded, s0 - 8 * parts, s0 - 7 * parts))
    return max_jump(instant, s0 - w, s0 + w), max_jump(faded, s0 - w, s0 + w), base


def main(argv: Optional[Sequence[str]] = None) -> int:
    args, dev = command_line(__doc__, [("out_path", str, "hotswap_ab.wav")], argv)
    dry, small, big = inputs()
    swap_block = int(1.2 * SR) // PARTS        # mid-phrase
    instant = render(dry, small, big, PARTS, swap_block, 0, dev)
    faded = render(dry, small, big, PARTS, swap_block, FADE, dev)
    j_inst, j_fade, j_base = jumps(instant, faded, PARTS, swap_block)
    print(f"max |sample step| at the swap: instant {j_inst:.4f}, "
          f"faded {j_fade:.4f} (program baseline {j_base:.4f})")

    gap = np.zeros(SR // 2, np.float32)
    dry_pad = np.pad(dry, (0, instant.size - dry.size))
    mixed = np.concatenate([0.7 * dry_pad + 0.6 * instant, gap,
                            0.7 * dry_pad + 0.6 * faded])
    write_wav(args.out_path, mixed / max(1.0, np.max(np.abs(mixed))))
    print(f"wrote {args.out_path}: instant swap then faded swap "
          f"(swap at block {swap_block}, fade {FADE} blocks = "
          f"{FADE * PARTS / SR * 1000:.0f} ms)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
