"""What the demos share: the synthesized sources and impulse responses, the
wav writer and the command line.

The synthesis is the JAX demos' own (``examples/demo.py`` and
``examples/tvconv_demo.py``), copied so that the port imports nothing of
the JAX package: at the same seeds it gives the same samples, bit for bit.
"""

from __future__ import annotations

import argparse
import wave
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.devices import get_device

SR = 44100


def pluck(freq: float, dur: float, rng) -> np.ndarray:
    """Karplus-Strong pluck."""
    n = int(SR * dur)
    period = max(2, int(SR / freq))
    buf = rng.standard_normal(period).astype(np.float32)
    out = np.empty(n, np.float32)
    for i in range(n):
        out[i] = buf[i % period]
        buf[i % period] = 0.5 * (buf[i % period] + buf[(i + 1) % period]) * 0.996
    return out


def synth_source(rng) -> np.ndarray:
    """A plucked arpeggio, 3.1 s, peak 0.5."""
    notes = [220.0, 277.18, 329.63, 440.0, 329.63, 277.18]
    hop = int(SR * 0.35)
    total = hop * len(notes) + SR
    sig = np.zeros(total, np.float32)
    for i, f in enumerate(notes):
        p = pluck(f, 0.9, rng)
        sig[i * hop: i * hop + p.size] += p
    return 0.5 * sig / np.max(np.abs(sig))


def synth_hall_ir(seconds: float, rng) -> np.ndarray:
    """A synthetic hall: exponentially decaying noise after a unit direct
    sound, peak 0.25."""
    n = int(SR * seconds)
    t = np.arange(n) / SR
    noise = rng.standard_normal(n).astype(np.float32)
    env = np.exp(-3.0 * t).astype(np.float32)
    ir = noise * env
    ir[0] = 1.0                     # direct sound
    return 0.25 * ir / np.max(np.abs(ir))


def noise_bursts(total: int, rng) -> np.ndarray:
    """30 ms noise bursts every 250 ms."""
    out = np.zeros(total, np.float32)
    period = int(SR * 0.25)
    for start in range(0, total - period, period):
        n = int(SR * 0.03)
        env = np.exp(-np.arange(n) / (SR * 0.005)).astype(np.float32)
        out[start: start + n] = rng.standard_normal(n).astype(np.float32) * env
    return out


def drone(total: int) -> np.ndarray:
    """A harmonic drone on 110 Hz with slow vibrato, peak 0.3."""
    t = np.arange(total) / SR
    f0 = 110.0
    sig = np.zeros(total, np.float32)
    for k, amp in [(1, 1.0), (2, 0.5), (3, 0.33), (5, 0.2), (8, 0.12)]:
        vib = 1.0 + 0.002 * np.sin(2 * np.pi * (0.1 * k) * t)
        sig += amp * np.sin(2 * np.pi * f0 * k * vib * t).astype(np.float32)
    return (0.3 * sig / np.max(np.abs(sig))).astype(np.float32)


def write_wav(path: str, audio: np.ndarray) -> None:
    """16-bit PCM wav of ``audio`` clipped to [-1, 1]: (T,) mono, or
    (channels, T), interleaved."""
    audio = np.atleast_2d(np.clip(audio, -1.0, 1.0))
    pcm = (audio * 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(pcm.shape[0])
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.T.reshape(-1).tobytes())


def quiet(msg: str, user_data=None) -> None:
    """A message callback that drops the message."""


def command_line(doc: str, positionals: Sequence[Tuple[str, type, object]],
                 argv: Optional[Sequence[str]] = None) -> Tuple[argparse.Namespace, torch.device]:
    """Parse a demo's optional positionals (name, type, default) and
    ``--device``; resolve the device: the card unless ``--device cpu`` is
    given. DeviceError when a card is asked for and there is none."""
    parser = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    for name, kind, default in positionals:
        parser.add_argument(name, type=kind, nargs="?", default=default)
    parser.add_argument("--device", default=None,
                        help="cuda (the default), cuda:i or cpu")
    args = parser.parse_args(argv)
    return args, get_device(device=args.device, on_message=quiet)
