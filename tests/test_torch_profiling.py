"""The port's profiling helpers (``opencl_fft_tpu_torch/utils/profiling.py``)
against the JAX package's on the CPU: ``median_chain_delta`` returns what
JAX's returns on the same fake timers (exactly: both are pure logic), the
FLOP conventions are equal, ``device_timer`` chains its step, and
``trace`` writes a Chrome trace of the enclosed work."""

import json

import numpy as np
import pytest
import torch

from opencl_fft_tpu.utils import profiling as JPF
from opencl_fft_tpu_torch.utils import profiling as PF


def _script(values):
    """A fake clock: two independent iterators over the same readings."""
    return iter(values), iter(values)


@pytest.mark.parametrize("values,reps,floor,kw", [
    ([0.010, 0.010, 0.050, 0.050, 0.012, 0.011, 0.049, 0.048,
      0.010, 0.010, 0.054, 0.052], 4, 1e-3, {}),
    ([0.010] * 40, 4, 1e-3, {}),
    ([0.010, 0.011, 0.9, 0.8, 0.02, 0.02, 0.3, 0.3, 0.01, 0.01, 0.5, 0.4] * 3, 8, 1e-3,
     {"samples": 2, "tries": 6}),
    ([0.005, 0.004, 0.006, 0.007] * 20, 2, 1e-4, {"pair": 1, "min_samples": 1}),
])
def test_median_chain_delta_equals_jax(values, reps, floor, kw):
    a, b = _script(values)
    calls_p, calls_j = [], []
    got = PF.median_chain_delta(lambda k: (calls_p.append(k), next(a))[1], reps, floor, **kw)
    want = JPF.median_chain_delta(lambda k: (calls_j.append(k), next(b))[1], reps, floor, **kw)
    assert got == want
    assert calls_p == calls_j


@pytest.mark.parametrize("reps,floor,min_chain_s,cap", [(4, 1e-5, 0.05, 256),
                                                        (2, 1e-9, 10.0, 8),
                                                        (3, 5e-3, 0.0, 256)])
def test_median_chain_delta_min_chain_span_equals_jax(reps, floor, min_chain_s, cap):
    """The span growth (min_chain_s, capped at max_reps_scale) takes the
    same chains and gives the same estimate as JAX's."""
    calls = {"p": [], "j": []}

    def timed(tag):
        def t(k):                        # exact 1 ms per chained call
            calls[tag].append(k)
            return 1e-3 * k
        return t

    got = PF.median_chain_delta(timed("p"), reps, floor, min_chain_s=min_chain_s,
                                max_reps_scale=cap)
    want = JPF.median_chain_delta(timed("j"), reps, floor, min_chain_s=min_chain_s,
                                  max_reps_scale=cap)
    assert got == want and calls["p"] == calls["j"]


def test_median_chain_delta_contract():
    """Floor-guarded and honest: every delta under the floor gives
    (None, 0), never a clamped value."""
    d, n = PF.median_chain_delta(lambda k: 0.010, 4, 1e-3)
    assert d is None and n == 0


@pytest.mark.parametrize("n,batch", [(1024, 1), (16, 2), (1 << 20, 7), (8, 3)])
def test_flop_conventions_equal_jax(n, batch):
    assert PF.fft_flops(n, batch) == JPF.fft_flops(n, batch)
    assert PF.pconv_flops_per_block(n, batch) == JPF.pconv_flops_per_block(n, batch)
    assert PF.fft_flops(1024) == 5 * 1024 * 10


def test_device_timer_chains_on_the_cpu():
    seen = []

    def step(x):
        seen.append(float(x[0]))
        return x + 1

    per = PF.device_timer(step, torch.zeros(4), iters=5)
    assert per > 0
    assert seen == [float(i) for i in range(7)]       # two warm-ups, then 5 chained
    state = (torch.zeros(3), 0)
    assert PF.device_timer(lambda s: (s[0] * 0.5, s[1] + 1), state, iters=3) > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with PF.trace(str(tmp_path)) as prof:
        a = torch.ones(64, 64)
        (a @ a).sum()
    data = json.loads((tmp_path / "trace.json").read_text())
    assert data["traceEvents"]
    assert any("mm" in e.key for e in prof.key_averages())
    assert PF.TRACE_DIR.parts[-3:] == ("build", "opencl_fft_tpu_torch", "trace")
    assert np.isfinite(PF.fft_flops(2))
