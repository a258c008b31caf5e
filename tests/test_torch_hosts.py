"""The port's audio-host bindings (``opencl_fft_tpu_torch/runtime/hosts.py``)
on the CPU: the PortAudio-convention ``PipelineCallback`` driven by the
paced ``VirtualHost`` over a pipeline, its output held to the port's step
chain bit for bit and to the JAX package's chain at 1e-5 of the scale; the
underrun count of a starved pipeline; the callback's errors; and
``open_host``'s fall back to the virtual host. No test here asserts zero
underruns on the CPU: where a comparison needs the stream whole, the
pipeline has computed it before the host starts."""

import shutil
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_fft_tpu.ops import pconv as JP
from opencl_fft_tpu_torch.ops import pconv as P
from opencl_fft_tpu_torch.runtime.hosts import (PipelineCallback, SoundDeviceHost, VirtualHost,
                                                open_host)
from opencl_fft_tpu_torch.runtime.pipeline import RealtimePipeline

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ on PATH")

RNG = np.random.default_rng(23)


def _chain(cfg, ir, blocks):
    st = P.push_ir(cfg, P.pconv_init(cfg, "cpu"), torch.from_numpy(ir))
    jcfg = JP.PconvConfig.for_ir_length(cfg.cvs, cfg.pts)
    jst = JP.push_ir(jcfg, JP.pconv_init(jcfg), jnp.asarray(ir))
    own, jax_out = [], []
    for b in blocks:
        st, o = P.pconv_step(cfg, st, torch.from_numpy(b))
        jst, jo = JP.pconv_step(jcfg, jst, jnp.asarray(b))
        own.append(o.numpy())
        jax_out.append(np.asarray(jo))
    return np.concatenate(own), np.concatenate(jax_out)


@pytest.mark.parametrize("gain", [1.0, 0.5])
def test_virtual_host_plays_the_pipeline(gain):
    """The pipeline computes the signal's blocks first; the paced host then
    pulls them through the callback (its own pushes are silence), two
    output channels. Captured stream = prime zeros, then the step chain
    times the gain, bit for bit."""
    pts, nparts, prime, nblocks = 128, 8, 2, 24
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts)
    ir = RNG.standard_normal(cfg.cvs).astype(np.float32) * 0.1
    blocks = RNG.standard_normal((nblocks, pts)).astype(np.float32) * 0.3
    own, jax_out = _chain(cfg, ir, blocks)
    outs = []

    def two_channels(indata, outdata, frames, time_info, status):
        out2 = np.zeros((frames, 2), np.float32)
        cb(indata, out2, frames, time_info, status)
        np.testing.assert_array_equal(out2[:, 0], out2[:, 1])   # broadcast
        outs.append(out2[:, 0].copy())
        outdata[:] = out2[:, :1]

    with RealtimePipeline(cfg, ir=ir, prime_blocks=prime, device="cpu") as pipe:
        pipe.push(blocks.reshape(-1))
        pipe.wait_for_blocks(nblocks, timeout=120)
        cb = PipelineCallback(pipe, gain=gain)
        host = VirtualHost(two_channels, sr=64000, frames=pts)
        with host:
            deadline = time.monotonic() + 120
            while len(host.captured) < prime + nblocks and time.monotonic() < deadline:
                time.sleep(0.005)
    got = host.output()[: (prime + nblocks) * pts]
    assert got.size == (prime + nblocks) * pts
    assert cb.callbacks >= prime + nblocks
    np.testing.assert_array_equal(got, np.concatenate(outs)[:got.size])
    np.testing.assert_array_equal(got[: prime * pts], 0.0)
    np.testing.assert_array_equal(got[prime * pts:], own * np.float32(gain))
    ref = jax_out * gain
    assert np.max(np.abs(got[prime * pts:] - ref)) <= 1e-5 * np.max(np.abs(ref))


def test_virtual_host_live_source_prefix():
    """A live source pushed by the callback itself: up to the first
    underrun (if the machine is loaded enough to cause one) the captured
    stream is the step chain delayed by the priming and the warm-up
    block, bit for bit; the underruns are only counted."""
    pts, nparts, prime = 128, 8, 4
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts)
    ir = RNG.standard_normal(cfg.cvs).astype(np.float32) * 0.1
    nframes = 40
    sig = RNG.standard_normal(nframes * pts).astype(np.float32) * 0.3
    pos = [0]

    def source(n):
        s = np.zeros(n, np.float32)
        take = min(n, sig.size - pos[0])
        if take > 0:
            s[:take] = sig[pos[0]:pos[0] + take]
            pos[0] += take
        return s

    under = []
    with RealtimePipeline(cfg, ir=ir, prime_blocks=prime, device="cpu") as pipe:
        pipe.push(np.zeros(pts, np.float32))
        pipe.wait_for_blocks(1, timeout=60)        # warm up outside the paced loop
        cb = PipelineCallback(pipe)

        def counted(*a):
            cb(*a)
            under.append(pipe.underrun_samples)

        host = VirtualHost(counted, sr=16000, frames=pts, source=source)
        with host:
            deadline = time.monotonic() + 120
            while len(host.captured) < nframes and time.monotonic() < deadline:
                time.sleep(0.005)
    out = host.output()
    clean = next((i for i, u in enumerate(under) if u), len(under))
    own, _ = _chain(cfg, ir, np.concatenate([np.zeros(pts, np.float32),
                                             sig]).reshape(-1, pts))
    n = min(clean * pts, out.size)
    want = np.concatenate([np.zeros(prime * pts, np.float32), own])[:n]
    np.testing.assert_array_equal(out[:n], want)


def test_virtual_host_counts_underruns_when_starved():
    """A pipeline whose worker never runs emits silence past its priming and
    counts every missing sample: what a sound card would play as dropouts."""
    pts = 128
    cfg = P.PconvConfig.for_ir_length(pts * 4, pts)
    pipe = RealtimePipeline(cfg, ir=np.ones(cfg.cvs, np.float32), prime_blocks=1,
                            device="cpu")
    cb = PipelineCallback(pipe)
    out = np.ones((pts, 1), np.float32)
    for _ in range(3):
        cb(np.ones((pts, 1), np.float32), out, pts, {}, 0)
        np.testing.assert_array_equal(out, 0.0)
    assert pipe.underrun_samples == 2 * pts
    assert cb.callbacks == 3


def test_virtual_host_surfaces_callback_error():
    def boom(indata, outdata, frames, time_info, status):
        raise RuntimeError("cable unplugged")

    with pytest.raises(RuntimeError, match="cable unplugged"):
        with VirtualHost(boom, sr=8000, frames=64):
            time.sleep(0.1)


def test_virtual_host_surfaces_pipeline_death():
    """A dead worker reaches the host through the callback's next push."""
    from opencl_fft_tpu_torch.runtime.pipeline import ProcessorPipeline

    class Broken:
        def process(self, block):
            raise RuntimeError("engine exploded")

    pipe = ProcessorPipeline(Broken(), 64, prime_blocks=1).start()
    pipe.push(np.zeros(64, np.float32))
    with pytest.raises(RuntimeError, match="worker died"):
        pipe.wait_for_blocks(1, timeout=30)
    with pytest.raises(RuntimeError, match="worker died"):
        with VirtualHost(PipelineCallback(pipe), sr=8000, frames=64):
            time.sleep(0.1)
    pipe.stop()


def test_open_host_falls_back_to_virtual():
    """Without the sounddevice package (or without an audio device) auto
    picks the virtual host; an explicit sounddevice request fails loudly."""
    cb = PipelineCallback.__new__(PipelineCallback)  # contract only
    host = open_host(cb, sr=8000, frames=64)
    try:
        import sounddevice  # noqa: F401
        assert isinstance(host, (SoundDeviceHost, VirtualHost))
    except ImportError:
        assert isinstance(host, VirtualHost)
        assert (host.sr, host.frames) == (8000, 64)
        with pytest.raises(RuntimeError, match="sounddevice"):
            open_host(cb, prefer="sounddevice")
    assert isinstance(open_host(cb, prefer="virtual"), VirtualHost)
    with pytest.raises(ValueError, match="unknown host preference"):
        open_host(cb, prefer="alsa")
