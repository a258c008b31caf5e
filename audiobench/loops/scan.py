"""Closed loop of whole scans: one caller hands ``blocks`` blocks of
``channels`` channels to ``Convolver.stream`` (LTI) or
``TVConvolver.stream`` (TV, a second operand beside), waits until the
output is complete, and calls again with the state chained.

Inputs cycle through ``segments`` seeded segments that live on the device,
so the window runs no kernel of the harness's own. The answers of
``check_calls`` calls, drawn from the seed over the window, are kept
whole and compared with the plain reference once the window has closed.

Mix parameters: channels, blocks, segments, check_calls.
"""

from __future__ import annotations

import math
import time

import torch

from .. import reference, roofline, signals
from ..trace import Reservoir


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Loop:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device,
                 control: bool = False):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.control = control
        self.tv = cfg["kind"] == "tv"
        self.pts, self.taps = cfg["partition"], cfg["taps"]
        self.nparts = self.taps // self.pts
        self.C, self.B, self.P = mix["channels"], mix["blocks"], mix["segments"]
        self.calls = 0          # calls made so far, warm-up included
        self.kept = Reservoir(mix["check_calls"], signals.host_rng(seed, 1))

    def setup(self) -> None:
        import opencl_fft_tpu_torch as port
        gen = signals.generator(self.seed, self.device)
        shape = (self.P, self.B, self.C, self.pts)
        self.irs = None if self.tv else signals.decaying_noise(gen, self.C, self.taps)
        self.xs = signals.noise(gen, shape)
        self.hs = signals.noise(gen, shape) if self.tv else None
        # the control: the program's own bfloat16 rings
        pcfg = port.PconvConfig.for_ir_length(self.taps, self.pts,
                                              ring_dtype="bf16" if self.control else "f32")
        if self.tv:
            self.engine = port.TVConvolver(pcfg, self.C, device=self.device)
        else:
            self.engine = port.Convolver(pcfg, self.C, device=self.device)
            self.engine.push_ir(self.irs)
        # warm up the one shape, and the allocator for the answers kept
        held = [self._call() for _ in range(self.kept.k + 1)]
        _sync(self.device)
        del held

    def _call(self) -> torch.Tensor:
        seg = self.calls % self.P
        self.calls += 1
        if self.tv:
            return self.engine.stream(self.xs[seg], self.hs[seg])
        return self.engine.stream(self.xs[seg])

    def window(self, seconds: float, tracer) -> dict:
        n = 0
        t0 = t_end = time.perf_counter()
        while t_end - t0 < seconds:
            i = self.calls
            with tracer.span("call"):
                out = self._call()
            with tracer.span("sync"):
                _sync(self.device)
            t_end = time.perf_counter()
            n += 1
            self.kept.offer((i, out))
        audio_s = n * self.B * self.C * self.pts / self.cfg["sample_rate"]
        least_ms, _ = roofline.scan_least_ms(self.C, self.B, self.nparts, self.pts, self.tv)
        return {"attempted": n,
                "metrics": {"audio_s_per_s": audio_s / (t_end - t0)},
                "counters": {"calls": n, "least_s": n * least_ms * 1e-3}}

    def release(self) -> None:
        self.engine = None

    def _history(self, pool: torch.Tensor, i: int, blocks_before: int):
        """Blocks of the calls that reach ``blocks_before`` blocks before
        call i, through call i: (C, T, pts), and the first block's index."""
        i0 = max(0, i - math.ceil(blocks_before / self.B))
        rows = torch.cat([pool[j % self.P] for j in range(i0, i + 1)])
        return rows.permute(1, 0, 2), i0 * self.B

    def check(self) -> list:
        """The relative error of each answer kept."""
        errors = []
        for i, out in self.kept.items:
            got = out.permute(1, 0, 2)                          # (C, B, pts)
            if self.tv:
                xb, first = self._history(self.xs, i, self.nparts + 1)
                hb, _ = self._history(self.hs, i, self.nparts + 1)
                ref = reference.tv_tail(xb, hb, first, self.B, self.nparts)
            else:
                xb, _ = self._history(self.xs, i, self.nparts)
                ref = reference.lti_tail(xb.reshape(self.C, -1), self.irs,
                                         self.B * self.pts).reshape(got.shape)
            errors.append(reference.rel_err(got, ref))
        return errors
