"""Audio-host bindings: drive a pipeline from a real audio callback.

The reference's L3 is literally a registered Csound plugin whose
``aperf`` runs inside the host engine's audio callback
(csound/opcode.cpp:229-252, 347-352). This module is the port's host
boundary, as ``opencl_fft_tpu/runtime/hosts.py`` is the JAX package's: a
single callback object (`PipelineCallback`, PortAudio calling convention)
that any of three hosts can drive:

  * `SoundDeviceHost` — a real duplex audio stream via the
    ``sounddevice`` (PortAudio) package, when installed. This is the
    production binding: the sound card's callback thread pushes captured
    frames into the pipeline's lock-free input ring and pulls processed
    frames from the primed output ring; the device worker never runs in
    the callback.
  * `VirtualHost` — a wall-clock-paced driver thread emulating a sound
    card interrupt at ``sr / frames`` Hz, invoking the SAME callback
    with the same calling convention, so the binding runs end to end
    (multi-second paced runs, underrun counts) with no audio hardware.
  * any other PortAudio-style host (the callback signature is the
    ``sounddevice.Stream`` contract: ``cb(indata, outdata, frames,
    time_info, status)`` with float32 arrays of shape (frames, ch)).

Latency model: the pipeline's ``prime_blocks`` is the budget; as long
as the worker sustains real time the callback never underruns, and the
emitted stream equals the engine's step chain delayed by exactly the
priming (runtime/pipeline.py docstring).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np


class PipelineCallback:
    """PortAudio-convention duplex callback bound to a pipeline.

    Real-time safe by construction: the only work in the callback is two
    lock-free ring operations (push captured input, pull processed
    output) — the device worker runs in its own thread. Channel 0 of the
    input feeds the pipeline; the processed stream is broadcast to all
    output channels.
    """

    def __init__(self, pipeline, gain: float = 1.0):
        self.pipeline = pipeline
        self.gain = float(gain)
        self.callbacks = 0

    def __call__(self, indata, outdata, frames, time_info, status):
        self.callbacks += 1
        self.pipeline.push(np.asarray(indata)[:, 0])
        out = self.pipeline.pull(int(frames)) * self.gain
        outdata[:] = out[:, None]


class SoundDeviceHost:
    """Duplex PortAudio stream driving a `PipelineCallback`.

    Requires the ``sounddevice`` package (an optional dependency: the
    import is deferred and the error message says how to get it).
    Mirrors the reference's in-engine opcode placement: the
    host owns the clock, the callback owns only ring operations.
    """

    def __init__(self, callback: PipelineCallback, sr: int = 48000,
                 frames: int = 512, device=None):
        try:
            import sounddevice as sd
        except ImportError as e:  # pragma: no cover - env-dependent
            raise RuntimeError(
                "SoundDeviceHost needs the 'sounddevice' package "
                "(pip install sounddevice); in environments without it "
                "use VirtualHost, which drives the same callback"
            ) from e
        self._sd = sd
        self.callback = callback
        self.stream = sd.Stream(
            samplerate=sr, blocksize=frames, channels=1, dtype="float32",
            device=device, callback=callback)

    def __enter__(self):
        self.stream.start()
        return self

    def __exit__(self, *exc):
        self.stream.stop()
        self.stream.close()


class VirtualHost:
    """Wall-clock-paced fake sound card: invokes the callback every
    ``frames / sr`` seconds with captured frames from ``source`` and
    collects what the callback writes to ``outdata``.

    The pacing thread is the "audio thread": late callback completions
    are counted (``late_callbacks``) exactly as a real host would xrun.
    """

    def __init__(self, callback: Callable, sr: int = 48000,
                 frames: int = 512,
                 source: Optional[Callable[[int], np.ndarray]] = None):
        self.callback = callback
        self.sr = int(sr)
        self.frames = int(frames)
        self._source = source or (lambda n: np.zeros(n, np.float32))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.captured: list[np.ndarray] = []
        self.late_callbacks = 0
        self.error: Optional[BaseException] = None

    def _run(self):
        period = self.frames / self.sr
        next_t = time.monotonic() + period
        try:
            while not self._stop.is_set():
                indata = np.ascontiguousarray(
                    self._source(self.frames), np.float32)[:, None]
                outdata = np.zeros((self.frames, 1), np.float32)
                self.callback(indata, outdata, self.frames,
                              {"t": time.monotonic()}, 0)
                self.captured.append(outdata[:, 0].copy())
                now = time.monotonic()
                if now > next_t + period:      # missed a whole period
                    self.late_callbacks += 1
                    next_t = now
                else:
                    time.sleep(max(0.0, next_t - now))
                next_t += period
        except Exception as e:                 # surfaced by stop()
            self.error = e

    def __enter__(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, exc_type, *exc):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if exc_type is None and self.error is not None:
            raise RuntimeError(
                f"virtual host callback died: {self.error!r}"
            ) from self.error

    def output(self) -> np.ndarray:
        return (np.concatenate(self.captured)
                if self.captured else np.zeros(0, np.float32))


def open_host(callback: PipelineCallback, sr: int = 48000,
              frames: int = 512, prefer: str = "auto", **kw):
    """Pick the best available host: sounddevice when importable (and
    ``prefer`` allows), else the paced virtual host."""
    if prefer not in ("auto", "sounddevice", "virtual"):
        raise ValueError(f"unknown host preference {prefer!r}")
    source = kw.pop("source", None)           # VirtualHost-only option
    if prefer in ("auto", "sounddevice"):
        try:
            return SoundDeviceHost(callback, sr=sr, frames=frames, **kw)
        except Exception:
            # auto must fall back on ANY open failure: with sounddevice
            # installed but no audio device (headless CI), sd.Stream()
            # raises sounddevice.PortAudioError, not RuntimeError
            if prefer == "sounddevice":
                raise
    return VirtualHost(callback, sr=sr, frames=frames, source=source)
