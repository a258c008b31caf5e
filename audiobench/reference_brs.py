"""The plain reference of head-tracked binaural room synthesis (BRS), for
the BRS cells: the BRIRs, each drawn from a seed of its own, and output
block t of each ear while the head turns,

    y_ear = (1 - r) sum_s x_s (*) h_{s, old, ear} + r sum_s x_s (*) h_{s, new, ear}

over the whole input history, r_n = (n + 1)/pts for n in [0, pts): the
ramp of a one-block crossfade from the BRIRs of the previous block's
orientation to this block's. Each convolution is ``reference.lti_tail``
(float64 ``torch.fft``, or bfloat16 for a control reference). It imports
nothing of the program.

A BRIR is ``signals.decaying_noise`` from a generator seeded by (run seed,
source, orientation, ear) alone, so the loop that fills the program's bank
and the check that redraws the few BRIRs it needs agree by construction.
"""

from __future__ import annotations

import numpy as np
import torch

from . import signals
from .reference import lti_tail


def brir_seed(seed: int, source: int, orientation: int, ear: int) -> int:
    """The seed of one BRIR, from the run's seed and its three indices."""
    seq = np.random.SeedSequence([int(seed) & (2**64 - 1), 0xB125, source, orientation, ear])
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def brirs(seed: int, sources, orientations, ears: int, taps: int,
          device: torch.device) -> torch.Tensor:
    """(len(sources), len(orientations), ears, taps) float32 BRIRs on
    ``device``, each drawn from its own seed."""
    gen = torch.Generator(device=device)
    rows = []
    for s in sources:
        for d in orientations:
            for e in range(ears):
                gen.manual_seed(brir_seed(seed, s, d, e))
                rows.append(signals.decaying_noise(gen, 1, taps)[0])
    return torch.stack(rows).reshape(len(sources), len(orientations), ears, taps)


def ear_block(x: torch.Tensor, h_old: torch.Tensor, h_new: torch.Tensor, pts: int,
              precision: str = "f64") -> torch.Tensor:
    """Output block of every ear, (ears, pts) float64, during a one-block
    crossfade from the BRIRs ``h_old`` to ``h_new``, each (sources, ears,
    L). x: (sources, S) input samples whose last is aligned with the
    block's last output sample, as for ``lti_tail``."""
    y_old = lti_tail(x[:, None], h_old, pts, precision).sum(dim=0)
    y_new = lti_tail(x[:, None], h_new, pts, precision).sum(dim=0)
    r = (torch.arange(pts, dtype=torch.float64, device=x.device) + 1) / pts
    return (1 - r) * y_old + r * y_new
