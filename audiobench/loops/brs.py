"""Closed loop of a head-tracked binaural renderer's block callbacks, one
listener: on each ``partition``-sample block the head takes a new yaw from
a seeded trajectory, every source's BRIRs switch to that yaw's
(``MatrixConvolver.switch``, a ``fade_blocks`` crossfade), one
``MatrixConvolver.step`` renders the sources' block into the ears, and the
ears' block is copied to the host, as an audio interface takes it, before
the next block begins.

The set-up fills the program's BRIR bank on the device one source at a
time (``inputs`` sources x ``orientations`` yaws at 1 degree x ``outputs``
ears, drawn by ``reference_brs.brirs``; yaw y is orientation y mod
``orientations``) and keeps no time-domain BRIR. The
head turns at ``turn_min_deg`` to ``turn_max_deg`` degrees a block,
reversing at seeded yaws within +-``yaw_limit_deg``, so the yaw changes on
every block and every block switches every pair. Inputs repeat every
``pool_samples`` samples, held on the host. The answers of
``check_blocks`` blocks, drawn from the seed over the window, each with
its two yaws, are compared once the window has closed with the plain
reference (``reference_brs.ear_block``), which redraws the BRIRs it needs.

Mix parameters: pool_samples, fade_blocks, turn_min_deg, turn_max_deg,
yaw_limit_deg, check_blocks.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import reference, reference_brs, roofline_xfade, signals
from ..trace import Reservoir

TRAJECTORY = 1 << 18     # yaws drawn at a time


class Loop:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device,
                 control: bool = False):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.control = control
        self.n_in, self.n_out, self.D = cfg["inputs"], cfg["outputs"], cfg["orientations"]
        self.pts, self.taps = cfg["partition"], cfg["taps"]
        self.nparts = self.taps // self.pts
        if mix["pool_samples"] % self.pts:
            raise ValueError(f"pool of {mix['pool_samples']} samples must hold whole blocks")
        self.P = mix["pool_samples"] // self.pts
        if 2 * mix["yaw_limit_deg"] + 1 > self.D:
            raise ValueError(f"yaws within +-{mix['yaw_limit_deg']} need more than "
                             f"{self.D} orientations at 1 degree")
        self.fade = mix["fade_blocks"]
        if self.fade != 1:
            raise ValueError("the reference blends over one block: fade_blocks must be 1")
        self.blocks = 0                          # blocks so far, warm-up included
        self.kept = Reservoir(mix["check_blocks"], signals.host_rng(seed, 1))
        self.turns = signals.host_rng(seed, 2)
        self.yaws = np.zeros(0, np.int64)

    def _extend(self, n: int) -> None:
        """Draw ``n`` more yaws of the trajectory: runs from one seeded
        turning point to the next in steps of ``turn_min_deg`` to
        ``turn_max_deg``, the direction reversing at each turning point
        where the limit leaves room."""
        lo, hi = self.mix["turn_min_deg"], self.mix["turn_max_deg"]
        lim = self.mix["yaw_limit_deg"]
        rng, runs, total = self.turns, [self.yaws], len(self.yaws)
        if total:
            yaw, up = int(self.yaws[-1]), self.up
        else:
            yaw, up = int(rng.integers(-lim, lim + 1)), bool(rng.integers(0, 2))
        while total < len(self.yaws) + n:
            # the next turning point, past at least one largest step
            if up and yaw + hi > lim or not up and yaw - hi < -lim:
                up = not up
            target = int(rng.integers(yaw + hi, lim + 1) if up else rng.integers(-lim, yaw - hi + 1))
            sign = 1 if up else -1
            steps = rng.integers(lo, hi + 1, size=abs(target - yaw))
            run = yaw + sign * np.cumsum(steps)
            run = run[sign * (run - target) <= 0]
            runs.append(run)
            total += len(run)
            yaw, up = int(run[-1]), not up
        self.yaws, self.up = np.concatenate(runs), up

    def setup(self) -> None:
        import opencl_fft_tpu_torch as port
        pcfg = port.PconvConfig.for_ir_length(self.taps, self.pts)
        self.engine = port.MatrixConvolver(pcfg, self.n_in, self.n_out, device=self.device)
        for s in range(self.n_in):
            bank = reference_brs.brirs(self.seed, [s], range(self.D), self.n_out, self.taps,
                                       self.device)
            self.engine.fill_bank(bank, first=s)
            del bank
        gen = signals.generator(self.seed, self.device)
        self.xs = signals.noise(gen, (self.P, self.n_in, self.pts)).cpu().numpy()
        self._extend(TRAJECTORY)
        for _ in range(4):                       # every shape, and the allocator
            self._block()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _block(self) -> np.ndarray:
        """One block: the head's yaw, the switch, the step, the ears' block
        to the host."""
        t = self.blocks
        self.blocks += 1
        if t >= len(self.yaws):
            self._extend(TRAJECTORY)
        self.engine.switch(np.full(self.n_in, self.yaws[t] % self.D), self.fade)
        x = torch.from_numpy(self.xs[t % self.P]).to(self.device)
        return self.engine.step(x).cpu().numpy()

    def window(self, seconds: float, tracer) -> dict:
        b0 = self.blocks
        t0 = t_end = time.perf_counter()
        while t_end - t0 < seconds:
            t = self.blocks
            with tracer.span("block"):
                y = self._block()
            t_end = time.perf_counter()
            self.kept.offer((t, y))
        n = self.blocks - b0
        audio_s = n * self.n_out * self.pts / self.cfg["sample_rate"]
        least_ms, _ = roofline_xfade.xfade_least_ms(self.n_in, self.n_out, self.nparts, self.pts)
        return {"attempted": n,
                "metrics": {"audio_s_per_s.opcode": audio_s / (t_end - t0)},
                "counters": {"blocks_fired": n, "least_s": n * least_ms * 1e-3},
                "notes": [f"{n} blocks, each switching {self.n_in * self.n_out} pairs"]}

    def release(self) -> None:
        self.engine = None

    def _history(self, t: int) -> torch.Tensor:
        """(inputs, S) samples up to the end of block t: the IR's reach
        before block t and block t (zeros before the first block)."""
        a, b = (t + 1) * self.pts - (self.taps - 1) - self.pts, (t + 1) * self.pts
        idx = np.arange(max(a, 0), b)
        blk, n = np.divmod(idx, self.pts)
        x = self.xs[blk % self.P, :, n].T                      # (inputs, b - max(a, 0))
        x = np.concatenate([np.zeros((self.n_in, max(0, -a)), np.float32), x], axis=1)
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _yaw_brirs(self, t: int) -> torch.Tensor:
        """(inputs, ears, taps) BRIRs of block t's yaw."""
        return reference_brs.brirs(self.seed, range(self.n_in), [int(self.yaws[t] % self.D)],
                                   self.n_out, self.taps, self.device)[:, 0]

    def check(self) -> list:
        """The relative error of each block kept; for the control, of the
        reference computed in bfloat16 in its place."""
        errors = []
        for t, y in self.kept.items:
            x, h_old, h_new = self._history(t), self._yaw_brirs(t - 1), self._yaw_brirs(t)
            ref = reference_brs.ear_block(x, h_old, h_new, self.pts)
            if self.control:
                got = reference_brs.ear_block(x, h_old, h_new, self.pts, "bf16")
            else:
                got = torch.from_numpy(y).to(self.device)
            errors.append(reference.rel_err(got, ref))
        return errors
