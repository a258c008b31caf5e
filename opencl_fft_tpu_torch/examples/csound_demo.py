"""Run the package's ``clconv.csd`` with the port's processors on the
Csound bus (engine-resident inserts; see
``opencl_fft_tpu_torch.runtime.csound_host``): a ``clconv`` insert (a
16,384-tap IR at parts 2048) and a ``cltvconv`` insert (parts 2048, size
16,384), both at ksmps 64, on the card.

Requires a Csound installation and the ctcsound bindings; exits 1 with a
clear message when they are absent (every other surface of the package
works without them).

Run:  python -m opencl_fft_tpu_torch.examples.csound_demo [--device cuda|cuda:i|cpu]
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from ..runtime import csound_host as ch
from ._common import command_line

CSD = Path(__file__).resolve().with_name("clconv.csd")
PARTS = 2048
SIZE = 16384
KSMPS = 64


def impulse_response() -> np.ndarray:
    """The clconv insert's IR: 16,384 taps of decaying noise from seed 0."""
    rng = np.random.default_rng(0)
    return (rng.standard_normal(SIZE) * np.exp(-np.arange(SIZE) / 4000.0)).astype(np.float32)


def inserts(device=None) -> List[ch.BusInsert]:
    """The two bus inserts of ``clconv.csd`` on ``device`` (None: the card)."""
    return [ch.clconv_insert(impulse_response(), parts=PARTS, block_size=KSMPS, device=device),
            ch.cltvconv_insert(parts=PARTS, size=SIZE, block_size=KSMPS, device=device)]


def main(argv: Optional[Sequence[str]] = None) -> int:
    if not ch.available():
        print("ctcsound is not importable — install Csound + ctcsound to "
              "run the engine-resident demo. The same signal path runs "
              "headlessly in tests/test_torch_csound.py.")
        return 1
    _, dev = command_line(__doc__, [], argv)
    ins = inserts(dev)
    host = ch.CsoundHost(CSD.read_text(), ins)
    cycles = host.run()
    print(f"performed {cycles} ksmps cycles with "
          f"{len(ins)} engine-resident inserts")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
