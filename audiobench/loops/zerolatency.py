"""Audio callbacks through the zero-latency engine, closed loop as a live
host runs them back to back: each callback hands ``samples`` samples
(numpy in, numpy out) to each of ``instances`` independent
``ClconvProcessor(ir, parts=0, block_size=samples, pmax)`` in turn, on one
thread, each with its own IR, and the next callback follows as soon as the
last returns.

The plan's last segment (the terminal one) fires one callback in
``group``, its partition over the block. Inputs are seeded signals, made
on the device and held on the host, that repeat every ``pool_samples``
samples. The answers of ``check_runs`` runs of ``group`` consecutive
callbacks, each starting just after a terminal firing (so every segment's
cadence falls inside it), drawn from the seed over the window, are kept
and compared once the window has closed with the plain reference: the
linear convolution of the input so far, at zero latency.

Mix parameters: instances, samples, pool_samples, check_runs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import reference, signals
from ..trace import Reservoir
from .callbacks import _quiet


class Loop:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device,
                 control: bool = False):
        from opencl_fft_tpu_torch.models import plan_segments
        self.cfg, self.seed, self.device = cfg, seed, device
        self.control = control
        self.taps, self.k = cfg["taps"], mix["samples"]
        if self.k != cfg["block_size"]:
            raise ValueError(f"callback of {self.k} samples must be the block {cfg['block_size']}")
        plan = plan_segments(self.taps, self.k, cfg["pmax"])
        self.group = plan[-1].pts // self.k if plan else 1   # callbacks a terminal firing
        self.N, self.period = mix["instances"], mix["pool_samples"]
        if self.period % self.k:
            raise ValueError(f"pool of {self.period} samples must hold whole callbacks")
        self.callbacks = 0                       # callbacks so far, warm-up included
        self.pending = []                        # outputs since the last terminal firing
        self.kept = Reservoir(mix["check_runs"], signals.host_rng(seed, 1))

    def setup(self) -> None:
        import opencl_fft_tpu_torch as port
        gen = signals.generator(self.seed, self.device)
        self.irs = signals.decaying_noise(gen, self.N, self.taps)
        irs = self.irs.cpu().numpy()
        self.procs = [port.ClconvProcessor(irs[n], 0, block_size=self.k, pmax=self.cfg["pmax"],
                                           device=self.device, on_message=_quiet)
                      for n in range(self.N)]
        self.xs = signals.noise(gen, (self.N, self.period)).cpu().numpy()
        for _ in range(2 * self.group):          # every segment fires twice
            self._callback()

    def _callback(self) -> list:
        """One callback through every instance; the outputs."""
        pos = (self.callbacks * self.k) % self.period
        self.callbacks += 1
        return [proc.process(self.xs[n, pos:pos + self.k]) for n, proc in enumerate(self.procs)]

    def window(self, seconds: float, tracer) -> dict:
        c0, terminal, terminal_s = self.callbacks, 0, 0.0
        t0 = t_end = time.perf_counter()
        while t_end - t0 < seconds:
            # one span over the callbacks in which the terminal segment does
            # not fire, one over the callback in which it does; no span a
            # callback
            with tracer.span("steps"):
                while (self.callbacks + 1) % self.group and t_end - t0 < seconds:
                    self.pending.append(self._callback())
                    t_end = time.perf_counter()
            if t_end - t0 >= seconds:
                break
            start = time.perf_counter()
            with tracer.span("terminal"):
                self.pending.append(self._callback())
            t_end = time.perf_counter()
            terminal += 1
            terminal_s += t_end - start
            self.kept.offer((self.callbacks // self.group - 1, self.pending))
            self.pending = []
        n = self.callbacks - c0
        audio_s = n * self.N * self.k / self.cfg["sample_rate"]
        return {"attempted": n,
                "metrics": {"audio_s_per_s.opcode": audio_s / (t_end - t0)},
                "counters": {"callbacks": n, "terminal_callbacks": terminal,
                             "terminal_s": terminal_s},
                "notes": [f"{n} callbacks, {terminal} of them firing the terminal segment"]}

    def release(self) -> None:
        self.procs = None

    def _stream(self, n: int, a: int, b: int) -> torch.Tensor:
        """Samples [a, b) of instance n's input (zeros before 0)."""
        idx = np.arange(max(a, 0), b) % self.period
        x = np.concatenate([np.zeros(max(0, -a), np.float32), self.xs[n, idx]])
        return torch.from_numpy(x).to(self.device)

    def _expected(self, g: int, precision: str) -> torch.Tensor:
        """Run g of every instance, (N, group * samples): the outputs of
        callbacks [g group, (g + 1) group), at zero latency."""
        n_out = self.group * self.k
        b = (g + 1) * n_out
        a = b - n_out - (self.taps - 1)
        return torch.stack([reference.lti_tail(self._stream(n, a, b), self.irs[n], n_out,
                                               precision) for n in range(self.N)])

    def check(self) -> list:
        """The relative error of each run kept; for the control, of the
        reference computed in bfloat16 in its place."""
        errors = []
        for g, run in self.kept.items:
            ref = self._expected(g, "f64")
            if self.control:
                got = self._expected(g, "bf16")
            else:
                got = torch.from_numpy(np.stack([np.concatenate([outs[n] for outs in run])
                                                 for n in range(self.N)])).to(self.device)
            errors.append(reference.rel_err(got, ref))
        return errors
