"""Closed loop of whole matrix scans: one caller hands ``blocks`` blocks of
the configuration's ``inputs`` channels to ``MatrixConvolver.stream``,
which mixes them through ``outputs`` x ``inputs`` IRs into ``outputs``
channels, waits until the output is complete, and calls again with the
state chained.

The scan loop's (``loops/scan.py``) over the matrix: its window, clock and
answers kept, with the outputs as its channels, so that ``audio_s_per_s``
counts the audio the matrix puts out. Inputs cycle through ``segments``
seeded segments that live on the device; the answers of ``check_calls``
calls, drawn from the seed over the window, are compared with the plain
reference (``reference_matrix``) once the window has closed.

Mix parameters: blocks, segments, check_calls.
"""

from __future__ import annotations

import torch

from .. import reference, reference_matrix, roofline_matrix, signals
from . import scan


class Loop(scan.Loop):
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device,
                 control: bool = False):
        super().__init__(cfg, dict(mix, channels=cfg["outputs"]), seed, device, control)
        self.n_in, self.n_out = cfg["inputs"], cfg["outputs"]

    def setup(self) -> None:
        import opencl_fft_tpu_torch as port
        gen = signals.generator(self.seed, self.device)
        irs = signals.decaying_noise(gen, self.n_out * self.n_in, self.taps)
        self.irs = irs.reshape(self.n_out, self.n_in, self.taps)
        self.xs = signals.noise(gen, (self.P, self.B, self.n_in, self.pts))
        # the control: the program's own bfloat16 rings
        pcfg = port.PconvConfig.for_ir_length(self.taps, self.pts,
                                              ring_dtype="bf16" if self.control else "f32")
        self.engine = port.MatrixConvolver(pcfg, self.n_in, self.n_out, device=self.device)
        self.engine.push_ir(self.irs)
        # warm up the one shape, and the allocator for the answers kept
        held = [self._call() for _ in range(self.kept.k + 1)]
        scan._sync(self.device)
        del held

    def window(self, seconds: float, tracer) -> dict:
        run = super().window(seconds, tracer)
        least_ms, _ = roofline_matrix.matrix_least_ms(self.n_in, self.n_out, self.B,
                                                      self.nparts, self.pts)
        run["counters"]["least_s"] = run["attempted"] * least_ms * 1e-3
        return run

    def check(self) -> list:
        """The relative error of each answer kept."""
        errors = []
        for i, out in self.kept.items:
            xb, _ = self._history(self.xs, i, self.nparts)       # (n_in, T, pts)
            ref = reference_matrix.matrix_tail(xb.reshape(self.n_in, -1), self.irs,
                                               self.B * self.pts)
            got = out.permute(1, 0, 2).reshape(self.n_out, -1)  # (n_out, B pts)
            errors.append(reference.rel_err(got, ref))
        return errors
