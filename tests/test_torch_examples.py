"""The port's demo command lines (``opencl_fft_tpu_torch/examples/``) on the
CPU, against the JAX demos (``examples/``) and the JAX package's engines.

The synthesis helpers are bit-equal to the JAX demos' at the same seeds.
Each demo's render, at a shortened source (0.3 s) and IR (0.05-0.1 s) with
the demo's own partition sizes and ``device="cpu"``, is held against the
JAX package's same processor or engine on the same inputs: to 1e-5 of
max|ref| for the per-block processors and the matrix scan, to 3e-5 for the
zero-latency engine, the pipelines (against the step chain) and the sharded
farm (the JAX tests' bars, ``tests/test_pipeline.py``,
``examples/dist_serving_demo.py``). The paced demos run to completion and
report their counts; no test asserts zero underruns under wall-clock
pacing, which depends on the host's load. No module of the port's examples
imports JAX, the JAX package or the JAX demos, and without a card no demo
runs unless ``--device cpu`` is given.
"""

import ast
import functools
import importlib.util
import pathlib
import shutil
import tomllib
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_fft_tpu import stream as jstream
from opencl_fft_tpu.models.convolver import Convolver as JConvolver
from opencl_fft_tpu.models.convolver import MatrixConvolver as JMatrixConvolver
from opencl_fft_tpu.models.lowlatency import ZeroLatencyConvolver as JZL
from opencl_fft_tpu.ops import pconv as J
from opencl_fft_tpu.utils import devices as jdevices
from opencl_fft_tpu.utils import numerics as jnumerics
from opencl_fft_tpu_torch import api
from opencl_fft_tpu_torch.examples import (_common, audio_host_demo, csound_demo, demo,
                                           dist_serving_demo, hotswap_demo, realtime_pipeline,
                                           stereo_demo, tvconv_demo, zl_demo)
from opencl_fft_tpu_torch.runtime import csound_host as ch
from opencl_fft_tpu_torch.stream import ClconvProcessor
from opencl_fft_tpu_torch.utils import devices, numerics
from opencl_fft_tpu_torch.utils.errors import DeviceError

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_EXAMPLES = ROOT / "opencl_fft_tpu_torch" / "examples"
DEMOS = ("demo", "tvconv_demo", "hotswap_demo", "stereo_demo", "zl_demo",
         "realtime_pipeline", "audio_host_demo", "csound_demo", "dist_serving_demo")
MODULES = {m.__name__.rsplit(".", 1)[1]: m for m in (
    demo, tvconv_demo, hotswap_demo, stereo_demo, zl_demo, realtime_pipeline,
    audio_host_demo, csound_demo, dist_serving_demo)}
SR = _common.SR
SHORT = int(0.3 * SR)        # the shortened source

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ on PATH")


def _jax_demo(name):
    """The JAX demo ``examples/<name>.py`` as a module (it puts examples/
    on sys.path itself)."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.all(np.isfinite(got))
    err = float(np.max(np.abs(got - ref)))
    scale = float(np.max(np.abs(ref)))
    assert scale > 0 and err <= tol * scale, (err, scale)


def _short_inputs():
    """0.3 s of the demo source and a 0.1 s hall IR, from seed 2024."""
    rng = np.random.default_rng(2024)
    return _common.synth_source(rng)[:SHORT], _common.synth_hall_ir(0.1, rng)


# -- the synthesis helpers and the wav writer ---------------------------------

def test_synthesis_is_bit_equal_to_the_jax_demos(tmp_path):
    jd, jtv, jst = _jax_demo("demo"), _jax_demo("tvconv_demo"), _jax_demo("stereo_demo")
    for seed in (2024, 7):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        assert np.array_equal(_common.synth_source(a), jd.synth_source(b))
        assert np.array_equal(_common.synth_hall_ir(0.3, a), jd.synth_hall_ir(0.3, b))
        assert np.array_equal(_common.pluck(329.63, 0.2, a), jd.pluck(329.63, 0.2, b))
        assert np.array_equal(_common.noise_bursts(SR, a), jtv.noise_bursts(SR, b))
    assert np.array_equal(_common.drone(SR), jtv.drone(SR))
    a, b = np.random.default_rng(2024), np.random.default_rng(2024)
    assert np.array_equal(stereo_demo.synth_stereo_source(a), jst.synth_stereo_source(b))
    assert np.array_equal(stereo_demo.synth_ir_matrix(0.1, 5120, a),
                          jst.synth_ir_matrix(0.1, 5120, b))
    # tvconv_demo.inputs, whose inputs are cheap to make
    bursts, drone = tvconv_demo.inputs(0.6)
    assert np.array_equal(bursts, jtv.noise_bursts(int(SR * 0.6), np.random.default_rng(7)))
    assert np.array_equal(drone, jtv.drone(int(SR * 0.6)))
    # the wav files, byte for byte: mono, clipped, and stereo
    x = np.random.default_rng(3).standard_normal((2, 1000)).astype(np.float32)
    for got, want, audio in ((tmp_path / "p.wav", tmp_path / "j.wav", x[0]),
                             (tmp_path / "p2.wav", tmp_path / "j2.wav", x)):
        _common.write_wav(str(got), audio)
        (jd.write_wav if audio.ndim == 1 else jst.write_stereo_wav)(str(want), audio)
        assert got.read_bytes() == want.read_bytes()
    with wave.open(str(tmp_path / "p2.wav")) as w:
        assert (w.getnchannels(), w.getframerate(), w.getnframes()) == (2, SR, 1000)
    jtv.write_wav(str(tmp_path / "j3.wav"), x[1])
    _common.write_wav(str(tmp_path / "p3.wav"), x[1])
    assert (tmp_path / "p3.wav").read_bytes() == (tmp_path / "j3.wav").read_bytes()


# -- the per-block demos against the JAX processors ---------------------------

@needs_gxx
def test_demo_render_matches_jax_and_steps_whole_partitions(monkeypatch):
    """64-sample host blocks into parts 1024: the accumulator hands the
    engine whole partitions, one step every 16 host blocks."""
    dry, ir = _short_inputs()
    steps = []
    convolution = api.Clpconv.convolution

    def counted(self, *a):
        steps.append(1)
        return convolution(self, *a)

    monkeypatch.setattr(api.Clpconv, "convolution", counted)
    wet = demo.render(dry, ir, "cpu")
    n = dry.size + (-dry.size) % demo.KSMPS + ir.size + demo.PARTS
    n -= n % demo.KSMPS
    assert wet.size == n and len(steps) == n // demo.PARTS
    proc = jstream.ClconvProcessor(ir, parts=demo.PARTS, on_message=_common.quiet)
    stream = np.concatenate([dry, np.zeros(n - dry.size, np.float32)])
    ref = np.concatenate([np.asarray(proc.process(stream[i:i + demo.KSMPS]))
                          for i in range(0, n, demo.KSMPS)])
    _close(wet, ref, 1e-5)
    mixed = demo.mix(dry, wet)
    assert mixed.shape == wet.shape and np.max(np.abs(mixed)) <= 1.0


@needs_gxx
def test_tvconv_render_matches_jax_with_the_freeze():
    a, b = tvconv_demo.inputs(0.3)
    frozen = (0.1, 0.2)
    wet = tvconv_demo.render(a, b, "cpu", frozen=frozen)
    tv = jstream.CltvconvProcessor(tvconv_demo.PARTS, tvconv_demo.SIZE,
                                   on_message=_common.quiet)
    bs = tvconv_demo.BLOCK
    ref, frozen_blocks = [], 0
    for i in range(a.size // bs):
        frz2 = not (frozen[0] < i * bs / SR < frozen[1])
        frozen_blocks += not frz2
        ref.append(np.asarray(tv.process(a[i * bs:(i + 1) * bs], b[i * bs:(i + 1) * bs],
                                         freeze2=frz2)))
    assert frozen_blocks > 0
    _close(wet, np.concatenate(ref), 1e-5)


@needs_gxx
@pytest.mark.parametrize("fade", [0, hotswap_demo.FADE])
def test_hotswap_render_matches_the_jax_demo(fade):
    """The instant (push_ir) and crossfaded (push_ir_xfade) swaps of a
    first IR padded to the longer one, against the JAX demo's render."""
    dry, _ = _short_inputs()
    rng = np.random.default_rng(7)
    small = _common.synth_hall_ir(0.05, rng)
    big = _common.synth_hall_ir(0.1, np.random.default_rng(8)) * 1.4
    parts, swap = hotswap_demo.PARTS, 6
    got = hotswap_demo.render(dry, small, big, parts, swap, fade, "cpu")
    ref = _jax_demo("hotswap_demo").render(dry, small, big, parts, swap, fade)
    _close(got, ref, 1e-5)


def test_stereo_render_matches_the_jax_matrix_scan():
    dry, cfg, irs = stereo_demo.inputs(ir_seconds=0.1)
    dry = dry[:, :SHORT]
    assert (cfg.pts, cfg.nparts) == (1024, 5)
    stream, wet = stereo_demo.render(dry, cfg, irs, "cpu")
    assert stream.shape == wet.shape and stream.shape[1] % cfg.pts == 0
    assert stream.shape[1] >= SHORT + cfg.cvs + cfg.pts
    jcfg = J.PconvConfig.for_ir_length(cfg.cvs, cfg.pts)
    conv = JMatrixConvolver(jcfg, n_in=2, n_out=2)
    conv.push_ir(jnp.asarray(irs))
    blocks = stream.reshape(2, -1, cfg.pts).transpose(1, 0, 2)
    ref = np.asarray(conv.stream(jnp.asarray(blocks))).transpose(1, 0, 2).reshape(2, -1)
    _close(wet, ref, 1e-5)


def test_zl_render_matches_jax_and_adds_no_latency():
    dry, ir = _short_inputs()
    assert zl_demo.latencies(ir, "cpu") == (0, zl_demo.PARTS)
    wet, segments = zl_demo.render(dry, ir, "cpu")
    assert [s.pts for s in segments] == [64, 128, 256, 512, 1024]
    zl = JZL(ir, block=zl_demo.BLOCK)
    b = zl_demo.BLOCK
    stream = np.concatenate([dry, np.zeros(wet.size - dry.size, np.float32)])
    ref = np.concatenate([np.asarray(zl.process(stream[i:i + b]))
                          for i in range(0, stream.size, b)])
    _close(wet, ref, 3e-5)


# -- the pipelines ------------------------------------------------------------

@needs_gxx
def test_realtime_pipeline_phases_match_the_step_chains():
    """Phase 1 (unpaced) pulls the priming and then the JAX pconv_step
    chain, phase 3 (unpaced) the priming and then the zero-latency
    processor's own run; the paced phase 2 runs to completion and reports
    its counts."""
    pts = 1024
    cfg, ir, blocks, blocks3 = realtime_pipeline.inputs(pts, 0.3, ir_len=1 << 13)
    assert blocks.shape == (64, pts) and blocks3.shape == (16, realtime_pipeline.BS3)
    prime = realtime_pipeline.PRIME
    r1 = realtime_pipeline.phase1(cfg, ir, blocks, "cpu")
    out = r1["out"]
    assert r1["rt"] > 0 and out.size >= (prime + 8) * pts
    assert not out[:prime * pts].any()
    jcfg = J.PconvConfig.for_ir_length(1 << 13, pts)
    st = J.push_ir(jcfg, J.pconv_init(jcfg), jnp.asarray(ir))
    step = jax.jit(functools.partial(J.pconv_step, jcfg))
    chain = []
    for blk in blocks:
        st, o = step(st, jnp.asarray(blk))
        chain.append(np.asarray(o))
    chain = np.concatenate(chain)
    got = out[prime * pts:]
    _close(got, chain[:got.size], 3e-5)

    r2 = realtime_pipeline.phase2(cfg, ir, blocks, "cpu")
    assert isinstance(r2["underruns"], int) and isinstance(r2["overruns"], int)
    assert r2["out"].shape == ((len(blocks) - 1) * pts,)

    r3 = realtime_pipeline.phase3(ir, blocks3, "cpu")
    bs = realtime_pipeline.BS3
    assert r3["segments"] == 2 and r3["out"].size >= (prime + 4) * bs
    assert (r3["paced"] is None) == (r3["rt"] < realtime_pipeline.BUDGET3)
    # the processor's own run (held against the JAX one in
    # tests/test_torch_lowlatency.py), bit for bit
    proc = ClconvProcessor(ir, parts=0, block_size=bs, pmax=realtime_pipeline.PMAX3,
                           device="cpu", on_message=_common.quiet)
    ref = np.concatenate([proc.process(b) for b in blocks3])
    got = r3["out"][prime * bs:]
    assert np.array_equal(got, ref[:got.size])


@needs_gxx
def test_realtime_pipeline_command_line_runs(capsys):
    """At 0.3 s and pts 1024 on the 2^17-tap IR: the device line, the three
    phases and an exit code of 0 or 1 by phase 2's counts."""
    rc = realtime_pipeline.main(["1024", "0.3", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device: cpu (cpu); pts=1024, IR 131072 taps (128 partitions)"
    assert lines[1].startswith("phase 1 (unpaced): 64 blocks in ")
    p2 = [ln for ln in lines if ln.startswith("phase 2 (paced @48kHz): 63 callbacks")]
    assert len(p2) == 1 and rc == (0 if "REALTIME OK" in p2[0] else 1)
    assert any(ln.startswith("phase 3 (zero-latency engine, 2048-sample blocks, 3 segments)")
               for ln in lines)


@needs_gxx
def test_audio_host_demo_runs_and_reports(capsys):
    res = audio_host_demo.run(0.3, 4096, "cpu", ir_len=1 << 13)
    assert res["host"] == "VirtualHost" and res["callbacks"] >= 1
    assert all(isinstance(res[k], int) for k in ("underruns", "overruns", "late"))
    assert capsys.readouterr().out.startswith(
        "host: VirtualHost; pts=4096, IR 8192 taps (2 partitions), 0.3s")


# -- csound, the sharded farm --------------------------------------------------

class _StubCsound:
    """The ctcsound.Csound surface CsoundHost uses: a score of ``cycles``
    ksmps cycles whose instruments chnset noise into every input channel."""

    def __init__(self, cycles):
        self.cycles, self.cycle, self.bus, self.csd = cycles, -1, {}, None
        self.rng = np.random.default_rng(5)

    def setOption(self, opt):
        pass

    def compileCsdText(self, text):
        self.csd = text
        return 0

    def start(self):
        return 0

    def ksmps(self):
        return csound_demo.KSMPS

    def performKsmps(self):
        self.cycle += 1
        if self.cycle >= self.cycles:
            return 1
        for chan in ("clconv_in", "cltvconv_in1", "cltvconv_in2"):
            self.bus[chan] = self.rng.standard_normal(csound_demo.KSMPS).astype(np.float32)
        return 0

    def audioChannel(self, name):
        return self.bus[name]

    def setAudioChannel(self, name, data):
        self.bus[name] = np.array(data, np.float32)

    def cleanup(self):
        pass


@needs_gxx
def test_csound_demo_without_and_with_ctcsound(monkeypatch, capsys):
    monkeypatch.setattr(ch, "ctcsound", None)
    assert csound_demo.main(["--device", "cpu"]) == 1
    assert capsys.readouterr().out.startswith("ctcsound is not importable")
    made = []

    class Module:
        @staticmethod
        def Csound():
            made.append(_StubCsound(cycles=40))
            return made[-1]

    monkeypatch.setattr(ch, "ctcsound", Module)
    assert csound_demo.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == (
        "performed 40 ksmps cycles with 2 engine-resident inserts")
    assert made[0].csd == csound_demo.CSD.read_text()
    assert made[0].csd.replace("opencl_fft_tpu_torch", "x").count("opencl_fft_tpu") == 0
    assert set(made[0].bus) >= {"clconv_out", "cltvconv_out"}
    # the inserts against the JAX processors, block by block
    ir = csound_demo.impulse_response()
    lti, tv = csound_demo.inserts("cpu")
    jl = jstream.ClconvProcessor(ir, parts=csound_demo.PARTS, on_message=_common.quiet)
    jt = jstream.CltvconvProcessor(csound_demo.PARTS, csound_demo.SIZE,
                                   on_message=_common.quiet)
    rng = np.random.default_rng(9)
    got, ref = [], []
    for _ in range(2 * csound_demo.PARTS // csound_demo.KSMPS + 3):
        a, b = rng.standard_normal((2, csound_demo.KSMPS)).astype(np.float32)
        got.append((lti.process(a), tv.process(a, b)))
        ref.append((np.asarray(jl.process(a)), np.asarray(jt.process(a, b))))
    for k in range(2):
        _close(np.concatenate([g[k] for g in got]), np.concatenate([r[k] for r in ref]), 1e-5)


def test_dist_serving_demo_matches_the_jax_engine(capsys):
    """Four gloo ranks on the balanced (2, 2) mesh: every channel against
    the JAX batched stream, and the demo's own channel-0 check, to 3e-5 of
    max(1, scale)."""
    res = dist_serving_demo.run(channels=8, nblocks=12, pts=32, nparts=8, ranks=4,
                                device="cpu")
    assert res["shape"] == (2, 2) and res["backend"] == "gloo" and res["rel"] <= 3e-5
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("devices: 1 (cpu), mesh dp=2 x tp=2 (4 gloo ranks)")
    assert out[-1].endswith("PASS")
    cfg, irs, blocks = dist_serving_demo.inputs(8, 12, 32, 8)
    jcfg = J.PconvConfig.for_ir_length(32 * 8, 32)
    conv = JConvolver(jcfg, 8)
    conv.push_ir(jnp.asarray(irs))
    ref = np.asarray(conv.stream(jnp.asarray(blocks)))
    err = float(np.max(np.abs(res["out"] - ref)))
    assert err <= 3e-5 * max(1.0, float(np.max(np.abs(ref))))
    assert dist_serving_demo.mesh_shape(8, 3, 16) == (1, 4)
    assert dist_serving_demo.mesh_shape(4, 8, 2) == (2, 2)
    assert dist_serving_demo.mesh_shape(9, 8, 16) == (1, 1)


# -- what the package may import, the device rules ------------------------------

def test_no_example_imports_jax_or_the_jax_package():
    files = sorted(PORT_EXAMPLES.glob("*.py"))
    assert {f.stem for f in files} >= set(DEMOS) | {"__init__", "_common"}
    banned = ("jax", "jaxlib", "opencl_fft_tpu", "examples") + DEMOS
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (f.name, name)
        assert "sys.path" not in f.read_text(), f.name


@pytest.mark.parametrize("name", DEMOS)
def test_demo_needs_a_card_unless_told_cpu(monkeypatch, tmp_path, name):
    """Without a card and without --device cpu each demo raises
    DeviceError before it renders anything."""
    mod = MODULES[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(ch, "ctcsound", object())       # csound_demo gets past its check

    def no_render(*a, **k):
        raise AssertionError("rendered without a device")

    for fn in ("render", "run", "inputs", "phase1", "inserts"):
        if hasattr(mod, fn):
            monkeypatch.setattr(mod, fn, no_render)
    argv = [str(tmp_path / "out.wav")] if name in DEMOS[:5] else []
    with pytest.raises(DeviceError):
        mod.main(argv)
    with pytest.raises(DeviceError):
        mod.main(argv + ["--device", "cuda:0"])


def test_render_functions_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ir = np.zeros(2048, np.float32)
    ir[0] = 1.0
    with pytest.raises(DeviceError):
        demo.render(np.zeros(256, np.float32), ir)
    with pytest.raises(DeviceError):
        zl_demo.render(np.zeros(256, np.float32), ir)
    with pytest.raises(DeviceError):
        dist_serving_demo.render()


# -- the utils helpers, the package data ----------------------------------------

def test_list_devices_lists_cards_only(monkeypatch):
    """The cards in index order, never the CPU (the JAX package lists its
    CPU devices: it has no other platform here)."""
    assert devices.list_devices() == []
    assert all(d.platform == "cpu" for d in jdevices.list_devices())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert devices.list_devices() == [torch.device("cuda", 0), torch.device("cuda", 1)]


@pytest.mark.parametrize("log2n", range(0, 13))
def test_bit_reverse_indices_match_jax(log2n):
    n = 1 << log2n
    got = numerics.bit_reverse_indices(n)
    want = jnumerics.bit_reverse_indices(n)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(np.sort(got), np.arange(n))
    for bad in (0, 3, 12, n + 3):
        if not numerics.is_pow2(bad):
            with pytest.raises(ValueError):
                numerics.bit_reverse_indices(bad)


def test_package_data_ships_what_the_port_reads_at_run_time():
    cfg = tomllib.loads((ROOT / "pyproject.toml").read_text())
    data = cfg["tool"]["setuptools"]["package-data"]
    shipped = {pathlib.Path(pkg.replace(".", "/")) / pat
               for pkg, pats in data.items() for pat in pats}

    def covered(path):
        rel = path.relative_to(ROOT)
        return any(rel.parent == g.parent and rel.match(g.name) for g in shipped) or any(
            rel.match(str(g)) for g in shipped)

    from opencl_fft_tpu_torch import runtime
    for path in (runtime._SRC, csound_demo.CSD):
        assert path.exists() and covered(path), path
    assert all(covered(p) for p in (ROOT / "opencl_fft_tpu_torch" / "csrc").iterdir())
