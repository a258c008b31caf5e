"""Plain reference of head-tracked binaural room synthesis: what
``MatrixConvolver`` with a BRIR bank (``fill_bank``, ``switch``) must
output, worked out from its inputs alone.

Input s carries, on each block, an outgoing and an incoming bank index
and a ramp r; output (ear) e of block t is

    y_e = sum_s (1 - r) x_s (*) h[s, old_s, e] + r x_s (*) h[s, new_s, e]

over the whole input history, each convolution from a zero history,
in float64 with ``torch.fft`` (index -1: the zero IR the engine starts
with). The indices and the ramp follow the crossfade's rules: a switch
before block t that changes an input's index starts a fade of F blocks,
r_n = (n + 1 + k·pts)/(F·pts) on its k-th block, for every input whose
index changed (the others blend a path with itself); a switch that
changes none does nothing; a switch mid-fade first adopts the indices in
flight; F = 0 takes the new indices at once. (An instant swap keeps the
outgoing IR's overlap-add tail for its first block, a click that the
reference does not model: it gives the exact convolution there.) It
imports nothing of either package and sets the card's TF32 switches off.
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def convolutions(x: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """x: (n_in, S), bank: (n_in, D, n_out, L). Returns (n_in, D, n_out, S)
    float64: the first S samples of x_s (*) bank[s, d, e]."""
    s, taps = x.shape[-1], bank.shape[-1]
    nfft = 1 << (s + taps - 2).bit_length()
    X = torch.fft.rfft(x.to(torch.float64), nfft)[:, None, None]
    H = torch.fft.rfft(bank.to(torch.float64), nfft)
    return torch.fft.irfft(X * H, nfft)[..., :s]


def render(x: torch.Tensor, bank: torch.Tensor, switches: dict, nblocks: int,
           pts: int) -> torch.Tensor:
    """x: (n_in, >= nblocks·pts) inputs; bank: (n_in, D, n_out, L);
    switches: {block t: (index (n_in,), fade_blocks)}, each made before
    block t is stepped. Returns (nblocks, n_out, pts) float64."""
    n_in = x.shape[0]
    ys = convolutions(x[:, :nblocks * pts], bank)              # (n_in, D, n_out, S)
    held = np.full(n_in, -1)
    old = held.copy()
    fade = None                                                 # (block of the fade, F)
    src = np.arange(n_in)
    out = []

    def paths(index, t):
        y = ys[src, np.maximum(index, 0), :, t * pts:(t + 1) * pts]   # (n_in, n_out, pts)
        return torch.where(torch.from_numpy(index >= 0)[:, None, None], y, torch.zeros_like(y))

    for t in range(nblocks):
        if t in switches:
            index, fade_blocks = switches[t]
            index = np.asarray(index)
            if (index != held).any():
                old = held.copy()                               # the targets in flight
                held = index.copy()
                fade = (t, fade_blocks) if fade_blocks else None
                if fade is None:
                    old = held.copy()
        if fade is None:
            out.append(paths(held, t).sum(dim=0))
            continue
        k, total = t - fade[0], fade[1]
        r = (torch.arange(pts, dtype=torch.float64) + 1 + k * pts) / (total * pts)
        out.append(((1 - r) * paths(old, t) + r * paths(held, t)).sum(dim=0))
        if k + 1 >= total:
            fade, old = None, held.copy()
    return torch.stack(out)
