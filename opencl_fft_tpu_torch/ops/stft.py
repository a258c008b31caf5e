"""Short-time Fourier transform on the port's FFT core.

Counterpart of ``opencl_fft_tpu/ops/stft.py``: the framing, windowing and
overlap-add layer that the reference's raw FFT opcodes are used to build.
Analysis is the standard unnormalized STFT (scipy.signal.stft up to its
scaling, for the same window and hop); synthesis is the windowed
overlap-add with the window-square (COLA) normalization.

Each frame goes through a full-size complex transform (``fft_split``: the
CUDA FFT kernel ``fft_vmem`` on a card at 2^10..2^20 points), so the
spectrum has the standard rfft layout (nfft//2 + 1 bins), not the packed
one of the convolution engines. The overlap-add sums of ``istft`` are
``torch.nn.functional.fold``, which gathers each output sample's
contributions in a fixed order: the result is deterministic on a card (no
atomic scatter-add).
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import numpy as np
import torch

from ..utils.numerics import is_pow2
from .cplx import Cplx
from .fft import fft_split
from .pconv import _on_device


@functools.lru_cache(maxsize=None)
def hann_np(n: int) -> np.ndarray:
    """Periodic Hann window (COLA at hop n/2, n/4, ...)."""
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)).astype(np.float32)


Device = Optional[Union[str, torch.device]]


def _signal(name: str, x, device: Device) -> torch.Tensor:
    """``x`` as float32 on ``device``, by ``convolve``'s device rule."""
    return torch.as_tensor(x, dtype=torch.float32, device=_on_device(name, x, device))


def _window(window: Optional[np.ndarray], nfft: int, device: torch.device) -> torch.Tensor:
    w = window if window is not None else hann_np(nfft)
    return torch.as_tensor(np.asarray(w, np.float32), device=device)


def frame(x, nfft: int, hop: int, device: Device = None) -> torch.Tensor:
    """(..., T) -> (..., nframes, nfft) sliding frames (zero-padded tail).
    ``device``: where to run; defaults to the device of ``x`` when it is a
    tensor."""
    x = _signal("frame", x, device)
    t = x.shape[-1]
    nframes = max(1, -(-(t - nfft) // hop) + 1) if t >= nfft else 1
    need = (nframes - 1) * hop + nfft
    x = torch.nn.functional.pad(x, (0, need - t))
    return x.unfold(-1, nfft, hop)


def stft(x, nfft: int = 1024, hop: Optional[int] = None,
         window: Optional[np.ndarray] = None, impl: str = "auto",
         device: Device = None) -> Cplx:
    """Real-input STFT -> split complex (..., nframes, nfft//2 + 1).
    ``device`` as for ``frame``."""
    if not is_pow2(nfft):
        raise ValueError(f"nfft must be a power of two, got {nfft}")
    hop = hop or nfft // 2
    x = _signal("stft", x, device)
    frames = frame(x, nfft, hop) * _window(window, nfft, x.device)
    re, im = fft_split((frames, torch.zeros_like(frames)), -1, impl)
    keep = nfft // 2 + 1
    return re[..., :keep], im[..., :keep]


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(..., nframes, nfft) -> (..., (nframes-1)*hop + nfft): frame f added
    at offset f*hop, by ``fold`` (each output sample sums its frames in a
    fixed order)."""
    *lead, nframes, nfft = frames.shape
    total = (nframes - 1) * hop + nfft
    cols = frames.reshape(-1, nframes, nfft).transpose(1, 2)      # (B, nfft, nframes)
    out = torch.nn.functional.fold(cols, (1, total), (1, nfft), stride=(1, hop))
    return out.reshape(*lead, total)


def istft(spec: Cplx, nfft: int = 1024, hop: Optional[int] = None,
          window: Optional[np.ndarray] = None, length: Optional[int] = None,
          impl: str = "auto") -> torch.Tensor:
    """Inverse STFT via windowed overlap-add with COLA normalization."""
    hop = hop or nfft // 2
    re, im = spec
    win = _window(window, nfft, re.device)
    # rebuild the full hermitian spectrum from the half layout
    fr = torch.cat([re, torch.flip(re[..., 1:-1], (-1,))], -1)
    fi = torch.cat([im, -torch.flip(im[..., 1:-1], (-1,))], -1)
    yr, _ = fft_split((fr, fi), +1, impl)
    out = _overlap_add(yr / nfft * win, hop)
    # COLA normalization: the sum of squared windows at each sample
    nframes = yr.shape[-2]
    wsum = _overlap_add((win * win).expand(nframes, nfft), hop)
    out = out / torch.clamp(wsum, min=1e-8)
    if length is not None:
        out = out[..., :length]
    return out


def spectrogram(x, nfft: int = 1024, hop: Optional[int] = None, impl: str = "auto",
                device: Device = None) -> torch.Tensor:
    """Power spectrogram |STFT|^2 (..., nframes, nfft//2 + 1); ``device``
    as for ``frame``."""
    re, im = stft(x, nfft, hop, impl=impl, device=device)
    return re * re + im * im
