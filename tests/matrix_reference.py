"""Plain reference of a convolution matrix: what ``MatrixConvolver`` must
output, worked out from its inputs alone.

Output o is the sum over the inputs i of the linear convolution of input i
with the impulse response h[o, i], from a zero history:

    y_o = sum_i x_i (*) h_{o,i}

computed in float64 with ``torch.fft``, a product of whole-signal spectra
per (o, i) pair. It imports nothing of either package and sets the card's
TF32 switches off, so that no float32 product on a card runs in TF32.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def matrix_convolve(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """x: (n_in, S) inputs, h: (n_out, n_in, L) impulse responses.
    Returns (n_out, S) in float64: the first S samples of each output."""
    if x.dim() != 2 or h.dim() != 3 or h.shape[1] != x.shape[0]:
        raise ValueError(f"x (n_in, S) and h (n_out, n_in, L) do not match: "
                         f"{tuple(x.shape)}, {tuple(h.shape)}")
    s, taps = x.shape[-1], h.shape[-1]
    nfft = 1 << (s + taps - 2).bit_length()
    X = torch.fft.rfft(x.to(torch.float64), nfft)                 # (n_in, F)
    H = torch.fft.rfft(h.to(torch.float64), nfft)                 # (n_out, n_in, F)
    y = torch.fft.irfft((H * X).sum(dim=1), nfft)                 # (n_out, nfft)
    return y[:, :s]
