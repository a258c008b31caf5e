"""The port's native host runtime (``opencl_fft_tpu_torch/runtime``): its
SPSC ring and block accumulator (its own copy of ``stream_rt.cpp``, built
with g++ into ``build/opencl_fft_tpu_torch/``), held bit for bit against the
JAX package's numpy accumulator and the port's own; the build rules (a
digest-named library, rebuilt when the source changes, a compile error
raises, the numpy fallback only without g++); and ``make_accumulator``."""

import shutil
import threading

import numpy as np
import pytest

from opencl_fft_tpu.stream import _BlockAccumulator as JaxAccumulator
from opencl_fft_tpu_torch import runtime
from opencl_fft_tpu_torch import stream as tstream

RNG = np.random.default_rng(77)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ on PATH")


def test_library_builds_under_build_dir():
    assert runtime.native_available()
    so = runtime.library_path()
    assert so.is_file()
    assert so.parent == runtime.BUILD_DIR
    assert so.parent != runtime._SRC.parent          # never beside the source


def test_ringbuffer_basic():
    rb = runtime.NativeRingBuffer(100)          # rounds up to 128
    assert rb.capacity == 128
    data = RNG.standard_normal(50).astype(np.float32)
    assert rb.write(data) == 50
    assert rb.available() == 50 and rb.space() == 78
    np.testing.assert_array_equal(rb.read(50), data)
    assert rb.available() == 0


def test_ringbuffer_wraparound_and_limits():
    rb = runtime.NativeRingBuffer(64)
    a = RNG.standard_normal(48).astype(np.float32)
    rb.write(a)
    np.testing.assert_array_equal(rb.read(40), a[:40])
    b = RNG.standard_normal(50).astype(np.float32)
    assert rb.write(b) == 50                     # wraps internally
    got = rb.read(100)                           # only 58 available
    np.testing.assert_array_equal(got, np.concatenate([a[40:], b]))
    big = RNG.standard_normal(100).astype(np.float32)
    assert rb.write(big) == 64                   # truncated, never torn
    np.testing.assert_array_equal(rb.read(64), big[:64])


def test_ringbuffer_threaded_spsc():
    """Producer and consumer on different threads: every sample arrives,
    in order (the lock-free contract)."""
    rb = runtime.NativeRingBuffer(1024)
    total = 100_000
    src = RNG.standard_normal(total).astype(np.float32)
    received = []

    def producer():
        pos = 0
        while pos < total:
            pos += rb.write(src[pos: pos + 256])

    def consumer():
        got = 0
        while got < total:
            chunk = rb.read(256)
            if chunk.size:
                received.append(chunk)
                got += chunk.size

    t1, t2 = threading.Thread(target=producer), threading.Thread(target=consumer)
    t1.start(); t2.start(); t1.join(); t2.join()
    np.testing.assert_array_equal(np.concatenate(received), src)


@pytest.mark.parametrize("parts,n_streams,ks", [(64, 1, 48), (64, 2, 64),
                                                (32, 2, 100), (16, 1, 5)])
def test_native_accumulator_equals_jax_numpy(parts, n_streams, ks):
    """The C++ accumulator, the JAX package's numpy accumulator and the
    port's: the same outputs and the same engine calls, bit for bit, for
    any host block size (tolerance 0)."""
    accs = {"native": runtime.NativeBlockAccumulator(parts, n_streams),
            "jax": JaxAccumulator(parts, n_streams),
            "port": tstream._BlockAccumulator(parts, n_streams)}
    calls = {k: [] for k in accs}

    def eng(tag):
        def run(bufin):
            calls[tag].append(np.array(bufin))
            return bufin[0] * 2.0 + 1.0
        return run

    for _ in range(7):
        blocks = RNG.standard_normal((n_streams, ks)).astype(np.float32)
        outs = {k: a.feed(blocks, eng(k)) for k, a in accs.items()}
        np.testing.assert_array_equal(outs["native"], outs["jax"])
        np.testing.assert_array_equal(outs["port"], outs["jax"])
        assert accs["native"].cnt == accs["jax"].cnt
    assert len(calls["native"]) == len(calls["jax"]) == len(calls["port"]) > 0
    for x, y in zip(calls["native"], calls["jax"]):
        np.testing.assert_array_equal(x, y)


def test_accumulator_latency_contract():
    """The first ``parts`` output samples are the initial (zero) bufout: the
    one-partition latency of opcode.cpp:240-249."""
    acc = runtime.NativeBlockAccumulator(8, 1)
    blocks = np.arange(16, dtype=np.float32)[None, :]
    out = acc.feed(blocks, lambda b: b[0])
    np.testing.assert_array_equal(out[:8], np.zeros(8))
    np.testing.assert_array_equal(out[8:], blocks[0, :8])


@pytest.fixture
def scratch_build(tmp_path, monkeypatch):
    """The runtime pointed at a copy of its source and a build dir under
    tmp_path, nothing loaded yet."""
    src = tmp_path / "stream_rt.cpp"
    shutil.copy(runtime._SRC, src)
    monkeypatch.setattr(runtime, "_SRC", src)
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(runtime, "_lib", None)
    return src


def test_edited_source_builds_anew(scratch_build):
    """An edit to stream_rt.cpp is never shadowed by a stale library: the
    library's name hashes the source, so the edit builds a new one."""
    first = runtime.library_path()
    assert not first.exists()
    assert runtime.load() is not None
    assert first.is_file()
    scratch_build.write_text(scratch_build.read_text() + "\n// edited\n")
    runtime._lib = None
    second = runtime.library_path()
    assert second != first and not second.exists()
    assert runtime.load() is not None
    assert second.is_file()


def test_compile_error_raises(scratch_build):
    scratch_build.write_text(scratch_build.read_text() + "\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        runtime.load()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tstream.make_accumulator(16)


def test_numpy_fallback_only_without_gxx(scratch_build, monkeypatch):
    monkeypatch.setattr(runtime.shutil, "which", lambda name: None)
    assert runtime.load() is None and not runtime.native_available()
    acc = tstream.make_accumulator(16, 2)
    assert isinstance(acc, tstream._BlockAccumulator)
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        runtime.NativeRingBuffer(16)


def test_make_accumulator_and_processors_take_native():
    assert isinstance(tstream.make_accumulator(32, 2), runtime.NativeBlockAccumulator)
    assert isinstance(tstream.make_accumulator(32, native=False), tstream._BlockAccumulator)
    ir = RNG.standard_normal(256).astype(np.float32)
    lti = tstream.ClconvProcessor(ir, 64, device="cpu", on_message=lambda m, u: None)
    tv = tstream.CltvconvProcessor(64, 256, device="cpu", on_message=lambda m, u: None)
    assert isinstance(lti._acc, runtime.NativeBlockAccumulator)
    assert isinstance(tv._acc, runtime.NativeBlockAccumulator)


@pytest.mark.parametrize("ks", [64, 48, 100])
def test_processors_on_native_accumulator_match_jax(ks):
    """ClconvProcessor / CltvconvProcessor on the native accumulator against
    the JAX processors (which take the JAX runtime's), any host block size,
    the TV freeze included: 1e-5 of the output scale."""
    from opencl_fft_tpu import stream as jstream

    rng = np.random.default_rng(ks)
    ir = (0.1 * rng.standard_normal(300)).astype(np.float32)
    t = tstream.ClconvProcessor(ir, 64, device="cpu", on_message=lambda m, u: None)
    j = jstream.ClconvProcessor(ir, 64, on_message=lambda m, u: None)
    tt = tstream.CltvconvProcessor(64, 256, device="cpu", on_message=lambda m, u: None)
    jt = jstream.CltvconvProcessor(64, 256, on_message=lambda m, u: None)
    got, want = [], []
    for i in range(12):
        a = rng.standard_normal(ks).astype(np.float32)
        b = rng.standard_normal(ks).astype(np.float32)
        f2 = i % 5 != 3
        got.append(np.concatenate([t.process(a), tt.process(a, b, freeze2=f2)]))
        want.append(np.concatenate([j.process(a), jt.process(a, b, freeze2=f2)]))
    got, want = np.concatenate(got), np.concatenate(want)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
