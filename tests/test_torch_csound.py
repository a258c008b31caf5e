"""The port's Csound binding (``opencl_fft_tpu_torch/runtime/csound_host.py``)
and the reference demo's signal path, on the CPU.

``CsoundHost.run()`` runs here on a stub ``ctcsound`` patched into the
module: a scripted orchestra that ``chnset``s each insert's input channels
from source signals every ksmps cycle and records what it ``chnget``s from
the output channel (the bus's one-cycle delay included). The signal-path
cases of ``tests/test_csound_workload.py`` are ported with the reference
.csd's parameters pinned (ksmps 64, 0dbfs 1, partition size 2048:
``csound/clconv.csd``), against float64 scipy at 5e-5 of the output scale
and against the JAX processors at 1e-5 of it."""

import os
import shutil

import numpy as np
import pytest
from scipy import signal as sps

from opencl_fft_tpu import stream as jstream
from opencl_fft_tpu_torch.runtime import csound_host as ch
from opencl_fft_tpu_torch.stream import ClconvProcessor, CltvconvProcessor

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ on PATH")

KSMPS, ZERODBFS, IPSIZE = 64, 1.0, 2048     # clconv.csd: ksmps, 0dbfs, the i2 p5
RNG = np.random.default_rng(11)
CPU = {"device": "cpu", "on_message": lambda m, u: None}


def _quiet(m, u):
    pass


class _StubCsound:
    """A scripted orchestra with the ctcsound.Csound surface that
    CsoundHost uses."""

    def __init__(self, script):
        self.script = script           # {"ksmps", "sources": {chan: signal}, "cycles"}
        self.options, self.csd, self.cycle = [], None, -1
        self.heard = {}                # channel -> blocks chnget by the orchestra
        self.bus = {}
        self.cleaned = False

    def setOption(self, opt):
        self.options.append(opt)

    def compileCsdText(self, text):
        self.csd = text
        return self.script.get("compile_rc", 0)

    def start(self):
        return self.script.get("start_rc", 0)

    def ksmps(self):
        return self.script["ksmps"]

    def performKsmps(self):
        """One cycle: the instruments chnget the host's last answers, then
        chnset this cycle's inputs; nonzero once the score has ended."""
        self.cycle += 1
        if self.cycle >= self.script["cycles"]:
            return 1
        k = self.script["ksmps"]
        for chan in self.script["outputs"]:
            self.heard.setdefault(chan, []).append(
                np.array(self.bus.get(chan, np.zeros(k, np.float32)), np.float32))
        for chan, sig in self.script["sources"].items():
            self.bus[chan] = sig[self.cycle * k:(self.cycle + 1) * k]
        return 0

    def audioChannel(self, name):
        return self.bus[name]

    def setAudioChannel(self, name, data):
        self.bus[name] = np.array(data, np.float32)

    def cleanup(self):
        self.cleaned = True

    def reset(self):
        self.cycle = -1


@pytest.fixture
def stub(monkeypatch):
    made = []

    class Module:
        @staticmethod
        def Csound():
            made.append(_StubCsound(Module.script))
            return made[-1]

    monkeypatch.setattr(ch, "ctcsound", Module)
    return Module, made


def _tv_operands(parts, cycles):
    icsize = parts * 8                       # the looping diskin operand's length
    beats = (RNG.standard_normal(icsize) * 0.2).astype(np.float32)
    fox = (RNG.standard_normal(cycles * KSMPS) * 0.3).astype(np.float32)
    idx = np.arange(cycles * KSMPS) % icsize
    return icsize, beats, fox, beats[idx]


def test_csound_host_runs_both_inserts(stub):
    """CsoundHost.run over the shipped examples/clconv.csd with a clconv
    and a cltvconv insert: each insert's bus output is the processor's
    stream one ksmps cycle late; the TV stream is the LTI convolution with
    the looping operand from the first block (plus one partition), the LTI
    stream the IR's; both within 5e-5 of float64 scipy."""
    module, made = stub
    parts, cycles = 256, 96
    icsize, beats, fox, looped = _tv_operands(parts, cycles)
    ir = (RNG.standard_normal(parts * 3) * 0.1).astype(np.float32)
    module.script = {"ksmps": KSMPS, "cycles": cycles,
                     "sources": {"clconv_in": fox, "cltvconv_in1": fox, "cltvconv_in2": looped},
                     "outputs": ("clconv_out", "cltvconv_out")}
    csd = open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "examples", "clconv.csd")).read()
    host = ch.CsoundHost(csd, [ch.clconv_insert(ir, parts=parts, block_size=KSMPS, **CPU),
                               ch.cltvconv_insert(parts=parts, size=icsize, block_size=KSMPS,
                                                  **CPU)])
    assert host.run() == cycles
    cs = made[0]
    assert cs.cleaned and cs.options == ["-n"] and cs.csd == csd
    n = cycles * KSMPS
    for chan, op in (("clconv_out", ir), ("cltvconv_out", beats)):
        got = np.concatenate(cs.heard[chan])
        full = sps.fftconvolve(fox.astype(np.float64), op.astype(np.float64))
        want = np.concatenate([np.zeros(KSMPS + parts), full])[:n]
        assert got.shape == (n,)
        np.testing.assert_allclose(got, want, atol=5e-5 * np.abs(want).max(), rtol=0)


def test_csound_host_max_cycles_and_failures(stub):
    module, made = stub
    sig = np.zeros(KSMPS * 50, np.float32)
    module.script = {"ksmps": KSMPS, "cycles": 50, "sources": {"clconv_in": sig},
                     "outputs": ("clconv_out",)}
    host = ch.CsoundHost("", [ch.clconv_insert(np.ones(64, np.float32), parts=16,
                                               block_size=KSMPS, **CPU)])
    assert host.run(max_cycles=7) == 7 and made[-1].cleaned
    host.reset()
    module.script = dict(module.script, compile_rc=3)
    with pytest.raises(RuntimeError, match="compile the CSD"):
        ch.CsoundHost("", [])
    module.script = dict(module.script, compile_rc=0, start_rc=1)
    with pytest.raises(RuntimeError, match="failed to start"):
        ch.CsoundHost("", []).run()


def test_csound_host_guarded(monkeypatch):
    """Without ctcsound the host refuses loudly, as SoundDeviceHost does."""
    monkeypatch.setattr(ch, "ctcsound", None)
    assert not ch.available()
    with pytest.raises(RuntimeError, match="ctcsound"):
        ch.CsoundHost("", [])


def test_bus_insert_factories_wire_channels():
    ins = ch.clconv_insert(np.ones(64, np.float32), parts=16, block_size=8, **CPU)
    assert ins.in_channels == ("clconv_in",)
    assert ins.out_channel == "clconv_out" and ins.latency_blocks == 1
    assert ins.process(np.zeros(8, np.float32)).shape == (8,)
    tv = ch.cltvconv_insert(parts=16, size=64, block_size=8, prefix="fx", **CPU)
    assert tv.in_channels == ("fx_in1", "fx_in2") and tv.out_channel == "fx_out"
    z = np.zeros(8, np.float32)
    assert tv.process(z, z).shape == (8,)


def test_clconv_csd_tvconv_signal_path():
    """instr 2: `tvconv ain1, ain2, 1, 1, ipsize, icsize` with ain2 a
    LOOPING source (diskin wrap=1) of icsize samples: the coefficient ring
    stays in the push_ir layout, so the output is the LTI convolution with
    that operand from the first block (one partition of opcode latency);
    the JAX processor on the same blocks to 1e-5 of the scale."""
    parts = IPSIZE
    cycles = parts * 10 // KSMPS
    icsize, beats, fox, looped = _tv_operands(parts, cycles)
    tv = CltvconvProcessor(parts, icsize, scale=ZERODBFS, block_size=KSMPS, **CPU)
    jtv = jstream.CltvconvProcessor(parts, icsize, scale=ZERODBFS, block_size=KSMPS,
                                    on_message=_quiet)
    got, jgot = [], []
    for i in range(cycles):
        a, b = fox[i * KSMPS:(i + 1) * KSMPS], looped[i * KSMPS:(i + 1) * KSMPS]
        got.append(tv.process(a, b, freeze1=True, freeze2=True))
        jgot.append(np.asarray(jtv.process(a, b, freeze1=True, freeze2=True)))
    got, jgot = np.concatenate(got), np.concatenate(jgot)
    full = sps.fftconvolve(fox.astype(np.float64), beats.astype(np.float64))
    expect = np.concatenate([np.zeros(parts), full])[:got.size]
    np.testing.assert_allclose(got, expect, atol=5e-5 * np.abs(full).max(), rtol=0)
    np.testing.assert_allclose(got, jgot, atol=1e-5 * np.abs(jgot).max(), rtol=0)


def test_clconv_csd_ftconv_signal_path():
    """instr 1: table IR + `ftconv ain1, gift, ipsize`: the IR scaled by
    0dbfs, a fixed partition size, one partition of latency; the JAX
    processor to 1e-5 of the scale."""
    parts = IPSIZE
    ir = (RNG.standard_normal(parts * 6)
          * np.exp(-np.arange(parts * 6) / (parts * 2.0))).astype(np.float32)
    cycles = parts * 8 // KSMPS
    fox = (RNG.standard_normal(cycles * KSMPS) * 0.3).astype(np.float32)
    conv = ClconvProcessor(ir, parts, scale=ZERODBFS, block_size=KSMPS, **CPU)
    jconv = jstream.ClconvProcessor(ir, parts, scale=ZERODBFS, block_size=KSMPS,
                                    on_message=_quiet)
    assert conv.latency == parts
    blocks = [fox[i * KSMPS:(i + 1) * KSMPS] for i in range(cycles)]
    got = np.concatenate([conv.process(b) for b in blocks])
    jgot = np.concatenate([np.asarray(jconv.process(b)) for b in blocks])
    full = sps.fftconvolve(fox.astype(np.float64), ir.astype(np.float64) * ZERODBFS)
    expect = np.concatenate([np.zeros(parts), full])[:got.size]
    np.testing.assert_allclose(got, expect, atol=5e-5 * np.abs(full).max(), rtol=0)
    np.testing.assert_allclose(got, jgot, atol=1e-5 * np.abs(jgot).max(), rtol=0)
