"""Audio callbacks through the opcode processors, closed loop as an
offline render runs them: each callback hands ``samples`` samples (numpy
in, numpy out) to each of ``instances`` independent processors in turn, on
one thread, and the next callback follows as soon as the last returns:
``ClconvProcessor(ir, parts)`` (LTI; each instance its own IR) or
``CltvconvProcessor(parts, size)`` (TV; two live operands).

Inputs are seeded signals, made on the device and held on the host, that
repeat every ``pool_blocks`` partitions. The answers of ``check_blocks``
partition-long runs of callbacks (one engine block of every instance),
drawn from the seed over the window, are kept and compared with the plain
reference once the window has closed.

Mix parameters: instances, samples, pool_blocks, check_blocks.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import reference, signals
from ..trace import Reservoir


def _quiet(message, user_data) -> None:
    """The processors' message callback: the run prints only its result."""


class Loop:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device,
                 control: bool = False):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.control = control
        self.tv = cfg["kind"] == "tv"
        self.pts, self.taps = cfg["partition"], cfg["taps"]
        self.nparts = self.taps // self.pts
        self.N, self.k = mix["instances"], mix["samples"]
        if self.pts % self.k:
            raise ValueError(f"callback of {self.k} samples must divide the partition {self.pts}")
        self.group = self.pts // self.k          # callbacks an engine block
        self.period = self.pts * mix["pool_blocks"]
        self.callbacks = 0                       # callbacks so far, warm-up included
        self.pending = []                        # outputs of the engine block under way
        self.kept = Reservoir(mix["check_blocks"], signals.host_rng(seed, 1))

    def setup(self) -> None:
        import opencl_fft_tpu_torch as port
        gen = signals.generator(self.seed, self.device)
        if self.tv:
            self.irs = None
            self.procs = [port.CltvconvProcessor(self.pts, self.taps, device=self.device,
                                                 on_message=_quiet)
                          for _ in range(self.N)]
        else:
            self.irs = signals.decaying_noise(gen, self.N, self.taps)
            irs = self.irs.cpu().numpy()
            self.procs = [port.ClconvProcessor(irs[n], self.pts, device=self.device,
                                               on_message=_quiet)
                          for n in range(self.N)]
        self.xs = signals.noise(gen, (self.N, self.period)).cpu().numpy()
        self.hs = signals.noise(gen, (self.N, self.period)).cpu().numpy() if self.tv else None
        for _ in range(2 * self.group):          # every instance fires twice
            self._callback()

    def _callback(self) -> list:
        """One callback through every instance; the outputs."""
        pos = (self.callbacks * self.k) % self.period
        self.callbacks += 1
        sl = slice(pos, pos + self.k)
        if self.tv:
            return [proc.process(self.xs[n, sl], self.hs[n, sl])
                    for n, proc in enumerate(self.procs)]
        return [proc.process(self.xs[n, sl]) for n, proc in enumerate(self.procs)]

    def window(self, seconds: float, tracer) -> dict:
        c0, fired, accum_s = self.callbacks, 0, 0.0
        t0 = t_end = time.perf_counter()
        while t_end - t0 < seconds:
            # one span over the callbacks that fire no engine block, one over
            # the callback that fires: a span a callback would cost the traced
            # window a third of its rate
            start, before = t_end, self.callbacks
            with tracer.span("accumulate"):
                while (self.callbacks + 1) % self.group and t_end - t0 < seconds:
                    self.pending.append(self._callback())
                    t_end = time.perf_counter()
            if self.callbacks > before:
                accum_s += t_end - start
            if t_end - t0 >= seconds:
                break
            with tracer.span("fire"):
                self.pending.append(self._callback())
            t_end = time.perf_counter()
            fired += 1
            self.kept.offer((self.callbacks // self.group - 1, self.pending))
            self.pending = []
        n = self.callbacks - c0
        audio_s = n * self.N * self.k / self.cfg["sample_rate"]
        return {"attempted": n,
                "metrics": {"audio_s_per_s.opcode": audio_s / (t_end - t0)},
                "counters": {"callbacks": n, "blocks_fired": fired * self.N,
                             "accumulate_callbacks": n - fired, "accumulate_s": accum_s},
                "notes": [f"{n} callbacks, {fired} engine blocks fired an instance"]}

    def release(self) -> None:
        self.procs = None

    def _stream(self, pool: np.ndarray, n: int, a: int, b: int) -> torch.Tensor:
        """Samples [a, b) of instance n's input (zeros before 0)."""
        idx = np.arange(max(a, 0), b) % self.period
        x = np.concatenate([np.zeros(max(0, -a), np.float32), pool[n, idx]])
        return torch.from_numpy(x).to(self.device)

    def _expected(self, t: int, precision: str) -> torch.Tensor:
        """Engine block t of every instance, (N, pts): the output of the
        callbacks one partition later (the opcode's latency)."""
        if t < 0:
            return torch.zeros(self.N, self.pts, dtype=torch.float64, device=self.device)
        rows = []
        for n in range(self.N):
            if self.tv:
                j0 = max(0, t - self.nparts)
                a, b = j0 * self.pts, (t + 1) * self.pts
                xb = self._stream(self.xs, n, a, b).reshape(-1, self.pts)
                hb = self._stream(self.hs, n, a, b).reshape(-1, self.pts)
                rows.append(reference.tv_tail(xb, hb, j0, 1, self.nparts, precision)[0])
            else:
                a, b = t * self.pts - (self.taps - 1), (t + 1) * self.pts
                x = self._stream(self.xs, n, a, b)
                rows.append(reference.lti_tail(x, self.irs[n], self.pts, precision))
        return torch.stack(rows)

    def check(self) -> list:
        """The relative error of each engine block kept; for the control,
        of the reference computed in bfloat16 in its place."""
        errors = []
        for g, group in self.kept.items:
            ref = self._expected(g - 1, "f64")
            if self.control:
                got = self._expected(g - 1, "bf16")
            else:
                got = torch.from_numpy(np.stack([np.concatenate([outs[n] for outs in group])
                                                 for n in range(self.N)])).to(self.device)
            errors.append(reference.rel_err(got, ref))
        return errors
