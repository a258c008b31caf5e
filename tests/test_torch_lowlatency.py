"""Port parity: the zero-latency convolver of opencl_fft_tpu_torch
(``models/lowlatency.py``: ``plan_segments``, ``ZeroLatencyConvolver``) and
``ClconvProcessor(parts=0)``, on every case of ``tests/test_lowlatency.py``
and ``tests/test_stream.py::test_clconv_zero_latency_dispatch``, against
scipy (atol 2e-5 * max, the JAX tests' bound) and against the JAX classes
on the same numpy-seeded inputs (2e-5 * max), on the CPU. A zero-latency
state crosses packages mid-stream in both directions through
``interop.zl_state_{to,from}_numpy``; the JAX checkpoint test's substance
(save mid-stream, resume bit-exact) runs through the same functions. On a
card, a pmax 4096 plan runs ``block_mac_unpack`` in its terminal segment.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal as sps

from opencl_fft_tpu import stream as jstream
from opencl_fft_tpu.models import lowlatency as JL
from opencl_fft_tpu.ops import dconv as JD
from opencl_fft_tpu.ops import pconv as JP
from opencl_fft_tpu_torch import stream as tstream
from opencl_fft_tpu_torch.interop import zl_state_from_numpy, zl_state_to_numpy
from opencl_fft_tpu_torch.models import ZeroLatencyConvolver, plan_segments
from opencl_fft_tpu_torch.ops.cuda import blockstep as B
from opencl_fft_tpu_torch.utils.errors import ArgumentError

torch.set_num_threads(1)

RNG = np.random.default_rng(11)


def _zl(ir, **kw):
    return ZeroLatencyConvolver(ir, device="cpu", **kw)


def _quiet(msg, user_data):
    pass


def _close(got, ref, rel=2e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=rel * np.max(np.abs(ref)), rtol=0)


def test_plan_invariants():
    """Segments tile [block, >=L) contiguously; every consumption delay
    is a positive integer number of engine blocks (offset % pts == 0)."""
    for L, B_, pmax in [(5000, 64, 256), (100000, 64, 1024), (65, 64, 128),
                        (4096, 128, 128), (3, 64, 64), (1 << 20, 64, 4096)]:
        segs = plan_segments(L, B_, pmax)
        cover = B_
        for s in segs:
            assert s.offset == cover
            assert s.offset % s.pts == 0
            assert s.delay == s.offset // s.pts >= 1
            assert s.pts <= pmax
            cover += s.length
        assert cover >= L
        # doubling phase: offset == pts (the latency-hiding identity)
        for s in segs[:-1]:
            assert s.offset == s.pts and s.nparts == 1 and s.delay == 1


def test_plan_matches_jax():
    """The same plan as JAX's over a grid that includes pmax 4096 plans,
    among them the 2^20-tap hall IR at block 64 (pts 64..2048 doubling,
    then 255 partitions of 4096)."""
    for L in (1, 64, 65, 300, 5000, 12388, 100000, 1 << 20):
        for B_ in (64, 128, 1024):
            for pmax in (64, 128, 1024, 4096, 8192):
                if pmax < B_:
                    continue
                got = [(s.offset, s.pts, s.nparts, s.delay) for s in plan_segments(L, B_, pmax)]
                want = [(s.offset, s.pts, s.nparts, s.delay)
                        for s in JL.plan_segments(L, B_, pmax)]
                assert got == want
    hall = plan_segments(1 << 20, 64, 4096)
    assert [s.pts for s in hall] == [64, 128, 256, 512, 1024, 2048, 4096]
    assert (hall[-1].offset, hall[-1].nparts, hall[-1].delay) == (4096, 255, 1)


def test_plan_rejects_bad_shapes():
    with pytest.raises(ValueError):
        plan_segments(1000, 100)            # non-pow2 block
    with pytest.raises(ValueError):
        plan_segments(1000, 64, pmax=32)    # pmax < block


@pytest.mark.parametrize("L,B_,pmax", [
    (5000, 64, 256),     # doubling + terminal
    (5000, 64, 128),     # short doubling phase, 39-partition terminal
    (9000, 64, 64),      # no doubling: uniform tail straight away
    (1000, 64, 1024),    # doubling only
    (300, 128, 1024),    # two segments
    (64, 64, 1024),      # head only
    (65, 64, 128),       # head + one partial segment
])
def test_render_matches_scipy_and_jax(L, B_, pmax):
    ir = RNG.standard_normal(L).astype(np.float32)
    x = RNG.standard_normal(3 * L // 2 + 257).astype(np.float32)
    zl = _zl(ir, block=B_, pmax=pmax)
    y = zl.render(x)
    ref = sps.fftconvolve(x, ir)
    assert y.shape == ref.shape
    _close(y, ref)
    _close(y, JL.ZeroLatencyConvolver(ir, block=B_, pmax=pmax).render(x))


def test_render_at_pmax_4096():
    """A terminal segment at pts 4096 (3 partitions: the route that runs
    block_mac_unpack on a card) behind doubling segments 1024 and 2048."""
    L, B_, pmax = 3 * 4096 + 100, 1024, 4096
    ir = RNG.standard_normal(L).astype(np.float32)
    x = RNG.standard_normal(3 * L // 2 + 257).astype(np.float32)
    zl = _zl(ir, block=B_, pmax=pmax)
    assert [(s.pts, s.nparts) for s in zl.segments] == [(1024, 1), (2048, 1), (4096, 3)]
    before = B.MAC_UNPACK_LAUNCHES
    y = zl.render(x)
    assert B.MAC_UNPACK_LAUNCHES == before          # the CPU runs the plain composition
    _close(y, sps.fftconvolve(x, ir))
    _close(y, JL.ZeroLatencyConvolver(ir, block=B_, pmax=pmax).render(x))


def test_streaming_is_zero_latency():
    """process() must emit y[tB:(t+1)B] at step t: block t of the true
    convolution, including the within-block (tap < B) contributions a
    one-partition-latency engine cannot produce."""
    ir = RNG.standard_normal(700).astype(np.float32)
    x = RNG.standard_normal(640).astype(np.float32)
    zl = _zl(ir, block=64, pmax=128)
    jzl = JL.ZeroLatencyConvolver(ir, block=64, pmax=128)
    ref = sps.fftconvolve(x, ir)
    for t in range(10):
        out = zl.process(x[64 * t: 64 * (t + 1)])
        assert out.shape == (64,) and out.dtype == np.float32
        np.testing.assert_allclose(out, ref[64 * t: 64 * (t + 1)],
                                   atol=2e-5 * np.max(np.abs(ref)), rtol=0)
        _close(out, jzl.process(x[64 * t: 64 * (t + 1)]))


def test_impulse_passthrough_is_immediate():
    """A unit impulse IR makes the convolver an identity with zero delay."""
    ir = np.zeros(500, np.float32)
    ir[0] = 1.0
    zl = _zl(ir, block=64, pmax=128)
    x = RNG.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(zl.process(x), x, atol=1e-5, rtol=0)


def test_state_is_deterministic_and_functional():
    """Two convolvers of one IR give bitwise equal streams; the step
    leaves the state it is given as it was."""
    ir = RNG.standard_normal(900).astype(np.float32)
    x = RNG.standard_normal(64).astype(np.float32)
    a = _zl(ir, block=64, pmax=256)
    b = _zl(ir, block=64, pmax=256)
    ya = np.concatenate([a.process(x) for _ in range(6)])
    yb = np.concatenate([b.process(x) for _ in range(6)])
    assert np.array_equal(ya, yb)
    before = zl_state_to_numpy(a.state)
    a._step(a.state, torch.from_numpy(x))
    after = zl_state_to_numpy(a.state)
    for s0, s1 in zip(before["segs"], after["segs"]):
        assert np.array_equal(s0["buf"], s1["buf"]) and np.array_equal(s0["queue"], s1["queue"])


def test_checkpoint_resume_bit_exact():
    """Save mid-stream (``zl_state_to_numpy``), restore into a fresh
    convolver (``zl_state_from_numpy``): the continuation is bit-identical
    (the JAX package's checkpoint test through the port's interop)."""
    ir = RNG.standard_normal(900).astype(np.float32)
    blocks = RNG.standard_normal((12, 64)).astype(np.float32)
    a = _zl(ir, block=64, pmax=256)
    for b in blocks[:5]:
        a.process(b)
    saved = zl_state_to_numpy(a.state)
    rest = np.stack([a.process(b) for b in blocks[5:]])
    b2 = _zl(ir, block=64, pmax=256)
    b2.state = zl_state_from_numpy(saved, "cpu")
    resumed = np.stack([b2.process(b) for b in blocks[5:]])
    assert np.array_equal(rest, resumed)


def _to_jax(d):
    """A JAX ZLState from ``zl_state_to_numpy``'s fields."""
    def arrays(m):
        return {k: jnp.asarray(v) for k, v in m.items()}

    return JL.ZLState(t=jnp.asarray(d["t"], jnp.int32), head=JD.DconvState(**arrays(d["head"])),
                      segs=tuple(JL._SegState(eng=JP.PconvState(**arrays(s["eng"])),
                                              buf=jnp.asarray(s["buf"]),
                                              queue=jnp.asarray(s["queue"]))
                                 for s in d["segs"]))


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_state_crosses_packages_mid_stream(direction):
    """A stream of 7 blocks on one package moves to the other mid-stream
    (off every engine's cadence: t = 7 with engines of r = 1, 2, 4, 8
    blocks), then both continue on the same blocks and agree."""
    ir = RNG.standard_normal(2000).astype(np.float32)
    blocks = RNG.standard_normal((20, 64)).astype(np.float32)
    src_j = JL.ZeroLatencyConvolver(ir, block=64, pmax=512)
    src_t = _zl(ir, block=64, pmax=512)
    for b in blocks[:7]:
        src_j.process(b)
        src_t.process(b)
    dst_j = JL.ZeroLatencyConvolver(ir, block=64, pmax=512)
    dst_t = _zl(ir, block=64, pmax=512)
    if direction == "jax_to_torch":
        dst_t.state = zl_state_from_numpy(src_j.state, "cpu")
        assert dst_t.state.t == 7
        pairs = (src_j, dst_t)
    else:
        dst_j.state = _to_jax(zl_state_to_numpy(src_t.state))
        pairs = (dst_j, src_t)
    ref = sps.fftconvolve(blocks.reshape(-1), ir)[:20 * 64].reshape(20, 64)
    for i, b in enumerate(blocks[7:], 7):
        yj, yt = pairs[0].process(b), pairs[1].process(b)
        _close(yt, yj, 1e-5)
        np.testing.assert_allclose(yt, ref[i], atol=2e-5 * np.max(np.abs(ref)), rtol=0)


def test_reset_restores_initial_output():
    ir = RNG.standard_normal(600).astype(np.float32)
    x = RNG.standard_normal(64).astype(np.float32)
    zl = _zl(ir, block=64, pmax=128)
    first = zl.process(x)
    for _ in range(5):
        zl.process(x)
    zl.reset()
    assert np.array_equal(first, zl.process(x))


def test_process_rejects_wrong_block():
    zl = _zl(np.ones(100, np.float32), block=64)
    with pytest.raises(ValueError):
        zl.process(np.zeros(32, np.float32))


def test_clconv_zero_latency_dispatch():
    """parts == 0 selects the non-uniform zero-latency engine: long-IR
    streaming with latency == 0, honoring skip/scale, the same output as
    the JAX processor."""
    ir = RNG.standard_normal(700).astype(np.float32)
    x = RNG.standard_normal(640).astype(np.float32)
    p = tstream.ClconvProcessor(ir, parts=0, block_size=64, skip=4, scale=0.5,
                                on_message=_quiet, device="cpu")
    jp = jstream.ClconvProcessor(ir, parts=0, block_size=64, skip=4, scale=0.5,
                                 on_message=_quiet)
    assert p.zero_latency and p.latency == 0 == jp.latency
    got = np.concatenate([p.process(x[i * 64:(i + 1) * 64]) for i in range(10)])
    expect = sps.fftconvolve(x, 0.5 * ir[4:])[: got.size]
    np.testing.assert_allclose(got, expect, atol=3e-5 * np.max(np.abs(expect)), rtol=0)
    jgot = np.concatenate([jp.process(x[i * 64:(i + 1) * 64]) for i in range(10)])
    _close(got, jgot)
    with pytest.raises(ArgumentError):
        p.process(np.zeros(32, np.float32))     # wrong block size
    with pytest.raises(ArgumentError, match="power of two"):
        tstream.ClconvProcessor(ir, parts=0, block_size=63, on_message=_quiet, device="cpu")
    with pytest.raises(ArgumentError, match="partitioned engine"):
        p.set_ir(ir)


def test_clconv_zero_latency_clamps_pmax():
    """pmax below block_size is clamped up to it, as in JAX."""
    ir = RNG.standard_normal(3000).astype(np.float32)
    p = tstream.ClconvProcessor(ir, parts=0, block_size=128, pmax=32, on_message=_quiet,
                                device="cpu")
    assert all(s.pts == 128 for s in p._engine.segments)
    x = RNG.standard_normal(128 * 6).astype(np.float32)
    got = np.concatenate([p.process(x[i * 128:(i + 1) * 128]) for i in range(6)])
    _close(got, sps.fftconvolve(x, ir)[:got.size], 3e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the block-step kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_pmax_4096_runs_mac_unpack(cuda_device):
    """On a card a pmax 4096 plan's terminal segment launches
    block_mac_unpack and its doubling segments block_step_fwd_fused; the
    render matches scipy."""
    L, B_ = 3 * 4096 + 100, 64
    ir = RNG.standard_normal(L).astype(np.float32)
    x = RNG.standard_normal(8192).astype(np.float32)
    n0, f0 = B.MAC_UNPACK_LAUNCHES, B.FWD_LAUNCHES
    y = ZeroLatencyConvolver(ir, block=B_, pmax=4096, device=cuda_device).render(x)
    assert B.MAC_UNPACK_LAUNCHES > n0 and B.FWD_LAUNCHES > f0
    _close(y, sps.fftconvolve(x, ir))
