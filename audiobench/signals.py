"""Seeded inputs, made on the run's device in a few large calls: impulse
responses (Gaussian noise under an exponential decay that reaches -60 dB at
the last tap, scaled to unit energy) and signals (Gaussian noise)."""

from __future__ import annotations

import math

import numpy as np
import torch

SIGNAL_RMS = 0.25


def generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def host_rng(seed: int, stream: int) -> np.random.Generator:
    """A host generator for the harness's own draws (which answers to
    keep), apart from the device generator that makes the inputs."""
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])


def decaying_noise(gen: torch.Generator, rows: int, taps: int) -> torch.Tensor:
    """(rows, taps) float32 impulse responses on the generator's device."""
    dev = gen.device
    n = torch.arange(taps, device=dev, dtype=torch.float32)
    env = torch.exp(n * (-math.log(1000.0) / max(taps - 1, 1)))
    ir = torch.randn((rows, taps), generator=gen, device=dev) * env
    return ir / ir.norm(dim=-1, keepdim=True)


def noise(gen: torch.Generator, shape: tuple) -> torch.Tensor:
    """Gaussian noise of RMS ``SIGNAL_RMS``, float32, on the generator's
    device."""
    return torch.randn(shape, generator=gen, device=gen.device) * SIGNAL_RMS
