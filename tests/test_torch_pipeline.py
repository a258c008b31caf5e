"""The port's real-time pipelines (``opencl_fft_tpu_torch/runtime/pipeline.py``)
on the CPU: the worker thread's output after the priming is bit-equal to
the port's own step chain and within 1e-5 of the output scale of the JAX
package's ``pconv_step`` chain (LTI, TV and the zero-latency processor);
worker death, the wait timeout, counted over/underruns, backpressure and
the block-size refusal. Every test drives the pipeline by push, then
``wait_for_blocks``, then pull: nothing is paced by the wall clock, so a
loaded machine cannot make a test underrun."""

import shutil
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_fft_tpu.ops import pconv as JP
from opencl_fft_tpu_torch.ops import pconv as P
from opencl_fft_tpu_torch.runtime.pipeline import ProcessorPipeline, RealtimePipeline
from opencl_fft_tpu_torch.stream import ClconvProcessor

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ on PATH")

RNG = np.random.default_rng(11)
PTS, NPARTS = 128, 8


def _quiet(m, u):
    pass


def _run(pipe, pushes, nblocks, prime, tv=False):
    """Push every block, wait for the worker, pull the priming and every
    output: the pulled stream, the pipeline's own counters checked."""
    with pipe:
        for blk in pushes:
            n = pipe.push(*blk) if tv else pipe.push(blk)
            assert n == (blk[0] if tv else blk).size
        pipe.wait_for_blocks(nblocks, timeout=120)
        got = pipe.pull((prime + nblocks) * pipe.block)
    assert pipe.underrun_samples == 0 and pipe.overrun_samples == 0
    assert pipe.blocks_processed == nblocks
    np.testing.assert_array_equal(got[: prime * pipe.block], 0.0)
    return got[prime * pipe.block:]


def _rel(got, ref):
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("prime", [1, 2])
def test_lti_pipeline_equals_step_chain(prime):
    """Blocks pushed in uneven pieces; the output after the priming is the
    port's pconv_step chain bit for bit, and JAX's to 1e-5 of the scale."""
    cfg = P.PconvConfig.for_ir_length(PTS * NPARTS, PTS)
    jcfg = JP.PconvConfig.for_ir_length(PTS * NPARTS, PTS)
    ir = RNG.standard_normal(cfg.cvs).astype(np.float32) * 0.1
    nblocks = 40
    blocks = RNG.standard_normal((nblocks, PTS)).astype(np.float32)
    st = P.push_ir(cfg, P.pconv_init(cfg, "cpu"), torch.from_numpy(ir))
    jst = JP.push_ir(jcfg, JP.pconv_init(jcfg), jnp.asarray(ir))
    own, jax_out = [], []
    for b in blocks:
        st, o = P.pconv_step(cfg, st, torch.from_numpy(b))
        jst, jo = JP.pconv_step(jcfg, jst, jnp.asarray(b))
        own.append(o.numpy())
        jax_out.append(np.asarray(jo))
    flat = blocks.reshape(-1)
    pieces = np.split(flat, [37, 300, 301, 2000, 4000])
    pipe = RealtimePipeline(cfg, ir=ir, prime_blocks=prime, device="cpu")
    got = _run(pipe, pieces, nblocks, prime)
    np.testing.assert_array_equal(got, np.concatenate(own))
    assert _rel(got, np.concatenate(jax_out)) <= 1e-5
    # the pipeline's state is the chain's
    for a, b in zip(pipe.state[:5], st[:5]):
        assert torch.equal(a, b)


def test_tv_pipeline_equals_step_chain():
    pts, nparts, prime = 64, 4, 2
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts)
    jcfg = JP.PconvConfig.for_ir_length(pts * nparts, pts)
    nblocks = 24
    bx = RNG.standard_normal((nblocks, pts)).astype(np.float32)
    bh = RNG.standard_normal((nblocks, pts)).astype(np.float32)
    st, jst = P.pconv_init(cfg, "cpu"), JP.pconv_init(jcfg)
    own, jax_out = [], []
    for i in range(nblocks):
        st, o = P.pconv_step_tv(cfg, st, torch.from_numpy(bx[i]), torch.from_numpy(bh[i]))
        jst, jo = JP.pconv_step_tv(jcfg, jst, jnp.asarray(bx[i]), jnp.asarray(bh[i]))
        own.append(o.numpy())
        jax_out.append(np.asarray(jo))
    pipe = RealtimePipeline(cfg, tv=True, prime_blocks=prime, device="cpu")
    got = _run(pipe, list(zip(bx, bh)), nblocks, prime, tv=True)
    np.testing.assert_array_equal(got, np.concatenate(own))
    assert _rel(got, np.concatenate(jax_out)) <= 1e-5


def test_tv_pipeline_rejects_unmatched_operands():
    cfg = P.PconvConfig.for_ir_length(64 * 4, 64)
    pipe = RealtimePipeline(cfg, tv=True, device="cpu")
    with pytest.raises(ValueError, match="matching x and h"):
        pipe.push(np.zeros(64, np.float32))
    with pytest.raises(ValueError, match="matching x and h"):
        pipe.push(np.zeros(64, np.float32), np.zeros(32, np.float32))


def test_processor_pipeline_zero_latency_stream():
    """ProcessorPipeline around the parts=0 (zero-added-latency) processor:
    after the priming, the processor's own run bit for bit, and the JAX
    processor's to 1e-5 of the scale; no algorithmic latency."""
    from opencl_fft_tpu import stream as jstream

    bs, prime, nblocks = 64, 2, 24
    ir = RNG.standard_normal(500).astype(np.float32) * 0.1
    blocks = RNG.standard_normal((nblocks, bs)).astype(np.float32)
    own = ClconvProcessor(ir, parts=0, block_size=bs, device="cpu", on_message=_quiet)
    jproc = jstream.ClconvProcessor(ir, parts=0, block_size=bs, on_message=_quiet)
    want = np.concatenate([own.process(b) for b in blocks])
    jwant = np.concatenate([np.asarray(jproc.process(b)) for b in blocks])
    proc = ClconvProcessor(ir, parts=0, block_size=bs, device="cpu", on_message=_quiet)
    assert proc.latency == 0
    got = _run(ProcessorPipeline(proc, bs, prime_blocks=prime), list(blocks), nblocks, prime)
    np.testing.assert_array_equal(got, want)
    assert _rel(got, jwant) <= 1e-5


def test_processor_pipeline_prime_zero():
    bs = 64
    ir = RNG.standard_normal(200).astype(np.float32) * 0.1
    blocks = RNG.standard_normal((6, bs)).astype(np.float32)
    want = ClconvProcessor(ir, parts=0, block_size=bs, device="cpu", on_message=_quiet)
    want = np.concatenate([want.process(b) for b in blocks])
    proc = ClconvProcessor(ir, parts=0, block_size=bs, device="cpu", on_message=_quiet)
    got = _run(ProcessorPipeline(proc, bs, prime_blocks=0), list(blocks), 6, 0)
    np.testing.assert_array_equal(got, want)


def test_processor_pipeline_rejects_block_size_mismatch():
    """Fixed-block processors are refused at construction, not by a dead
    worker later."""
    proc = ClconvProcessor(RNG.standard_normal(256).astype(np.float32), parts=0,
                           block_size=64, device="cpu", on_message=_quiet)
    with pytest.raises(ValueError, match="fixed at 64"):
        ProcessorPipeline(proc, 128)
    with pytest.raises(ValueError, match="prime_blocks"):
        ProcessorPipeline(proc, 64, prime_blocks=-1)
    cfg = P.PconvConfig.for_ir_length(64 * 4, 64)
    with pytest.raises(ValueError, match="prime_blocks"):
        RealtimePipeline(cfg, prime_blocks=0, device="cpu")


class _Broken:
    def process(self, block):
        raise RuntimeError("engine exploded")


def test_worker_death_is_surfaced_not_silent():
    """A processor that raises never deadlocks the pipeline: the error
    re-raises from wait_for_blocks / push / pull / __exit__."""
    pipe = ProcessorPipeline(_Broken(), 64, prime_blocks=1).start()
    pipe.push(np.zeros(64, np.float32))
    with pytest.raises(RuntimeError, match="worker died"):
        pipe.wait_for_blocks(1, timeout=30.0)
    with pytest.raises(RuntimeError, match="worker died"):
        pipe.push(np.zeros(64, np.float32))
    with pytest.raises(RuntimeError, match="worker died"):
        pipe.pull(64)
    pipe.stop()
    pipe2 = ProcessorPipeline(_Broken(), 64, prime_blocks=1)
    with pytest.raises(RuntimeError, match="worker died"):
        with pipe2:
            pipe2._in_x.write(np.zeros(64, np.float32))  # a ring op only, so
            # __exit__ does the surfacing
            deadline = time.monotonic() + 30.0
            while pipe2.error is None and time.monotonic() < deadline:
                time.sleep(1e-3)


def test_engine_error_in_worker_is_surfaced():
    """A processor whose output is not audio kills the worker loudly too."""
    class Short:
        def process(self, block):
            return "not audio"

    pipe = ProcessorPipeline(Short(), 64).start()
    pipe.push(np.zeros(64, np.float32))
    with pytest.raises(RuntimeError, match="worker died"):
        pipe.wait_for_blocks(1, timeout=30.0)
    pipe.stop()


def test_wait_for_blocks_times_out():
    class Idle:
        def process(self, block):    # pragma: no cover — never fed
            return block

    pipe = ProcessorPipeline(Idle(), 64).start()
    with pytest.raises(TimeoutError):
        pipe.wait_for_blocks(1, timeout=0.05)
    pipe.stop()


def test_overrun_underrun_and_backpressure_are_counted():
    cfg = P.PconvConfig.for_ir_length(64 * 4, 64)
    pipe = RealtimePipeline(cfg, ir=np.zeros(cfg.cvs, np.float32), prime_blocks=1,
                            capacity_blocks=2, device="cpu")
    # worker not started: pushes beyond the ring's capacity are overruns
    assert pipe.push(np.zeros(64 * 8, np.float32)) == 64 * 2
    assert pipe.overrun_samples == 64 * 8 - 64 * 2
    # only the priming block is there: pulling more underruns
    assert pipe.pull(64 * 3).size == 64 * 3
    assert pipe.underrun_samples == 64 * 2
    # backpressure: the output ring (3 blocks + 1 prime, a power of two)
    # full, the worker holds its input until the consumer drains
    full = RealtimePipeline(cfg, ir=np.zeros(cfg.cvs, np.float32), prime_blocks=1,
                            capacity_blocks=3, device="cpu")
    assert full.push(np.ones(64 * 4, np.float32)) == 64 * 4
    with full:
        full.wait_for_blocks(3, timeout=60)
        time.sleep(0.2)
        assert full.blocks_processed == 3
        assert full.pull_available() == 64 * 4
        full.pull(64 * 4)
        full.wait_for_blocks(4, timeout=60)
    assert full.blocks_processed == 4 and full.overrun_samples == 0



def test_stress_producer_consumer_threads():
    """A producer thread pushes and a consumer thread pulls while the worker
    runs an identity processor, the interpreter switching threads every
    microsecond: every sample arrives once and in order after the priming
    (the rings' SPSC contract and the pipeline's counters under
    contention), within a time bound."""
    import sys
    import threading

    class Identity:
        def process(self, block):
            return block.copy()

    bs, prime, nblocks = 64, 2, 2000
    src = RNG.standard_normal(nblocks * bs).astype(np.float32)
    got = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pipe = ProcessorPipeline(Identity(), bs, prime_blocks=prime, capacity_blocks=8)
        with pipe:
            def producer():
                pos = 0
                while pos < src.size:
                    if pipe.blocks_processed * bs + 4 * bs > pos:
                        pos += pipe.push(src[pos:pos + bs])
                    else:
                        time.sleep(1e-5)

            def consumer():
                n = 0
                while n < (nblocks + prime) * bs:
                    k = pipe.pull_available()
                    if k:
                        got.append(pipe.pull(k))
                        n += k
                    else:
                        time.sleep(1e-5)

            threads = [threading.Thread(target=fn, daemon=True) for fn in (producer, consumer)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    out = np.concatenate(got)
    assert pipe.underrun_samples == 0 and pipe.overrun_samples == 0
    assert pipe.blocks_processed == nblocks
    np.testing.assert_array_equal(out[: prime * bs], 0.0)
    np.testing.assert_array_equal(out[prime * bs:], src)
