"""What ``correct`` must catch, on the CPU at tiny sizes: the control (the
precision below the configuration's float32) and each fault a cell can
have, planted under the entry the window drives. Each run has to come out
not correct. One card holds each cell, so no exchange between chips can be
left out."""

from __future__ import annotations

import numpy as np
import pytest

import opencl_fft_tpu_torch as port
from opencl_fft_tpu_torch.ops import pconv
from audiobench.conftest import CELLS, LTI_INSERTS, add_cell, run_cell

SCANS = {"lti2p17_stream64": port.Convolver, "tv2p22_stream1": port.TVConvolver}
OPCODES = {"tv2p22_csound_ksmps64": "pconv_step_tv"}


def _not_correct(root, cell, capsys, control=0):
    rc, line = run_cell(root, cell, capsys, control=control)
    assert rc == 0
    assert line["correct"] is False and line["failed"] > 0
    check = line["checks"]["max_rel_err"]
    assert check["value"] > check["limit"]
    return check["value"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(tiny_root, capsys, cell):
    """bfloat16 rings (the program's own path, the scans) or the reference
    computed in bfloat16 (the processors) read ~2e-3."""
    assert _not_correct(tiny_root, cell, capsys, control=1) > 5e-4


def _wrap_stream(monkeypatch, cls, after):
    orig = cls.stream

    def stream(self, *blocks, **kw):
        state = self.state
        out = orig(self, *blocks, **kw)
        return after(self, state, out)

    monkeypatch.setattr(cls, "stream", stream)


def _wrap_step(monkeypatch, name, after):
    orig = getattr(pconv, name)

    def step(cfg, state, *blocks):
        new, out = orig(cfg, state, *blocks)
        return after(state, new, out)

    monkeypatch.setattr(pconv, name, step)


@pytest.mark.parametrize("cell", CELLS)
def test_state_left_unchanged(tiny_root, capsys, monkeypatch, cell):
    if cell in SCANS:
        def keep(self, state, out):
            self.state = state
            return out
        _wrap_stream(monkeypatch, SCANS[cell], keep)
    else:
        _wrap_step(monkeypatch, OPCODES[cell], lambda state, new, out: (state, out))
    _not_correct(tiny_root, cell, capsys)


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered(tiny_root, capsys, monkeypatch, cell):
    """One sample of every call's (every engine block's) output changed
    where it is produced."""
    def alter(out):
        out = out.clone()
        out.view(-1)[0] += 1.0
        return out
    if cell in SCANS:
        _wrap_stream(monkeypatch, SCANS[cell], lambda self, state, out: alter(out))
    else:
        _wrap_step(monkeypatch, OPCODES[cell], lambda state, new, out: (new, alter(out)))
    _not_correct(tiny_root, cell, capsys)


def test_half_the_channels_left_out(tiny_root, capsys, monkeypatch):
    def half(self, state, out):
        out = out.clone()
        out[:, out.shape[1] // 2:] = 0
        return out
    _wrap_stream(monkeypatch, port.Convolver, half)
    _not_correct(tiny_root, "lti2p17_stream64", capsys)


def test_half_the_inserts_left_out(tiny_root, capsys, monkeypatch):
    made = []
    orig_init, orig_process = port.ClconvProcessor.__init__, port.ClconvProcessor.process

    def init(self, *a, **kw):
        orig_init(self, *a, **kw)
        self.skipped = len(made) % 2 == 1
        made.append(self)

    def process(self, block):
        if self.skipped:
            return np.zeros_like(np.asarray(block, np.float32))
        return orig_process(self, block)

    monkeypatch.setattr(port.ClconvProcessor, "__init__", init)
    monkeypatch.setattr(port.ClconvProcessor, "process", process)
    add_cell(tiny_root, *LTI_INSERTS)
    _not_correct(tiny_root, LTI_INSERTS[0], capsys)
