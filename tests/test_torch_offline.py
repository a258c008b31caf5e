"""Port parity: the chunked, offline and decomposed engines of
opencl_fft_tpu_torch against opencl_fft_tpu on the same inputs.

``pconv_chunk{,_tv}``, ``pconv_offline``, ``_offline_batched``,
``pconv_stream_batched_chunked``, ``convolve_oneshot``, the LTI
``stream_decomposed``, ``Convolver.render`` and ``Convolver.stream(chunk>1)``
are each held against the JAX function (outputs atol 1e-5 * max|JAX|, rings
atol 1e-5 * max|ring|), with the state crossing packages mid-stream through
``interop.py``. The JAX side runs its Pallas kernels in interpret mode where
they are on its path: ``pallas="on"`` takes the offline MAC to ``chunk_mac``
(``macflow_lti_batched`` above 16 channels), ``pallas="macflow"`` takes
``stream_decomposed`` to ``macflow_lti``. Where the JAX contract is
bit-exact (``pconv_chunk{,_tv}`` against sequential steps), the port is
held to it against its own steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal as sps

from opencl_fft_tpu.models import convolver as JM
from opencl_fft_tpu.ops import decomposed as JD
from opencl_fft_tpu.ops import pconv as J
from opencl_fft_tpu_torch import models as M
from opencl_fft_tpu_torch.interop import pconv_state_from_numpy, pconv_state_to_numpy
from opencl_fft_tpu_torch.ops import pconv as P
from opencl_fft_tpu_torch.ops.cuda import slidemac as S
from opencl_fft_tpu_torch.ops.decomposed import stream_decomposed

torch.set_num_threads(1)

CPU = "cpu"
RINGS = ("spec_x_re", "spec_x_im", "spec_h_re", "spec_h_im")
TOL = 1e-5


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, ref, rel=TOL):
    ref = _np(ref)
    got = _np(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=rel * (np.abs(ref).max() + 1e-30), rtol=0)


def _assert_state_close(got, ref):
    for name in RINGS + ("tail",):
        _close(getattr(got, name), getattr(ref, name))
    for name in ("wp", "wp2"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(ref, name)), err_msg=name)


def _assert_state_equal(got, ref):
    for name in RINGS + ("tail",):
        np.testing.assert_array_equal(_np(getattr(got, name)), _np(getattr(ref, name)),
                                      err_msg=name)
    assert (got.wp, got.wp2) == (ref.wp, ref.wp2)


def _to_jax(state):
    return J.PconvState(**{k: jnp.asarray(v) for k, v in pconv_state_to_numpy(state).items()})


def _to_port(jstate):
    return pconv_state_from_numpy(J.PconvState(*map(np.asarray, jstate)), CPU)


def _cfgs(pts, nparts, pallas="off", bin0_mode="exact"):
    return (J.PconvConfig(pts=pts, nparts=nparts, bin0_mode=bin0_mode, pallas=pallas),
            P.PconvConfig(pts=pts, nparts=nparts, bin0_mode=bin0_mode))


def _seeded(tcfg, rng, nch=None):
    """A port state with a random IR pushed (nch channels when given)."""
    if nch is None:
        ir = rng.standard_normal(tcfg.cvs).astype(np.float32)
        return P.push_ir(tcfg, P.pconv_init(tcfg, CPU), torch.from_numpy(ir))
    irs = (0.3 * rng.standard_normal((nch, tcfg.cvs))).astype(np.float32)
    return P.push_ir(tcfg, M.batched_state(tcfg, nch, CPU), torch.from_numpy(irs))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# pconv_chunk / pconv_chunk_tv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("nch", [None, 3])
def test_chunk_bitwise_equals_sequential_steps(k, nch):
    """K-block chunks reproduce K sequential pconv_step calls exactly (the
    JAX contract, tests/test_pconv.py), one channel or a batched state."""
    cfg = P.PconvConfig(pts=32, nparts=8)
    rng = np.random.default_rng(k + (nch or 0))
    st0 = _seeded(cfg, rng, nch)
    shape = (24, 32) if nch is None else (24, nch, 32)
    blocks = _t(rng.standard_normal(shape).astype(np.float32))
    st, seq = st0, []
    for b in blocks:
        st, o = P.pconv_step(cfg, st, b)
        seq.append(o)
    st2, outs = st0, []
    for i in range(0, 24, k):
        st2, o = P.pconv_chunk(cfg, st2, blocks[i:i + k])
        outs.append(o)
    np.testing.assert_array_equal(torch.cat(outs).numpy(), torch.stack(seq).numpy())
    _assert_state_equal(st2, st)


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("nch", [None, 2])
def test_chunk_tv_bitwise_equals_sequential_steps(k, nch):
    cfg = P.PconvConfig(pts=16, nparts=8)
    rng = np.random.default_rng(10 + k + (nch or 0))
    st0 = _seeded(cfg, rng, nch)
    shape = (24, 16) if nch is None else (24, nch, 16)
    bx = _t(rng.standard_normal(shape).astype(np.float32))
    bh = _t((0.3 * rng.standard_normal(shape)).astype(np.float32))
    st, seq = st0, []
    for x, h in zip(bx, bh):
        st, o = P.pconv_step_tv(cfg, st, x, h)
        seq.append(o)
    st2, outs = st0, []
    for i in range(0, 24, k):
        st2, o = P.pconv_chunk_tv(cfg, st2, bx[i:i + k], bh[i:i + k])
        outs.append(o)
    np.testing.assert_array_equal(torch.cat(outs).numpy(), torch.stack(seq).numpy())
    _assert_state_equal(st2, st)


@pytest.mark.parametrize("tv", [False, True])
def test_chunk_matches_jax_across_packages(tv):
    """Chunks of 3, 8 and 5 blocks through both packages, the state moving
    JAX -> port after the first chunk and port -> JAX after the second."""
    jcfg, tcfg = _cfgs(32, 8)
    rng = np.random.default_rng(20 + tv)
    ts = _seeded(tcfg, rng)
    js = _to_jax(ts)
    for i, k in enumerate((3, 8, 5)):
        bx = rng.standard_normal((k, 32)).astype(np.float32)
        bh = (0.3 * rng.standard_normal((k, 32))).astype(np.float32)
        if tv:
            js, jo = J.pconv_chunk_tv(jcfg, js, jnp.asarray(bx), jnp.asarray(bh))
            ts, to = P.pconv_chunk_tv(tcfg, ts, _t(bx), _t(bh))
        else:
            js, jo = J.pconv_chunk(jcfg, js, jnp.asarray(bx))
            ts, to = P.pconv_chunk(tcfg, ts, _t(bx))
        _close(to, jo)
        _assert_state_close(ts, js)
        if i == 0:
            ts = _to_port(js)
        elif i == 1:
            js = _to_jax(ts)


def test_chunk_validates_its_size():
    cfg = P.PconvConfig(pts=16, nparts=4)
    st = P.pconv_init(cfg, CPU)
    for k in (0, 5):
        with pytest.raises(ValueError, match=r"chunk size must be in \[1, nparts=4\]"):
            P.pconv_chunk(cfg, st, torch.zeros((k, 16)))
        with pytest.raises(ValueError, match=r"chunk size must be in \[1, nparts=4\]"):
            P.pconv_chunk_tv(cfg, st, torch.zeros((k, 16)), torch.zeros((k, 16)))
    with pytest.raises(ValueError, match=r"blocks must be \(K, 16\)"):
        P.pconv_chunk(cfg, st, torch.zeros((2, 2, 16)))
    with pytest.raises(ValueError, match="blocks_h"):
        P.pconv_chunk_tv(cfg, st, torch.zeros((2, 16)), torch.zeros((3, 16)))
    bst = M.batched_state(cfg, 2, CPU)._replace(wp=(0, 1))
    with pytest.raises(ValueError, match="shared by every channel"):
        P.pconv_chunk(cfg, bst, torch.zeros((2, 2, 16)))


# ---------------------------------------------------------------------------
# offline render
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nbs", [(13, 6), (3, 21)])
def test_offline_matches_jax_chunk_mac_route(nbs):
    """pconv_offline against the JAX one through its chunk_mac kernel
    (pallas="on", interpret mode); the two calls cover the nb < nparts and
    nb >= nparts ring rebuilds, the state crossing JAX -> port between."""
    jcfg, tcfg = _cfgs(128, 8, pallas="on")
    rng = np.random.default_rng(sum(nbs))
    ts = _seeded(tcfg, rng)
    js = _to_jax(ts)
    for i, nb in enumerate(nbs):
        blocks = rng.standard_normal((nb, 128)).astype(np.float32)
        js, jo = J.pconv_offline(jcfg, js, jnp.asarray(blocks))
        ts, to = P.pconv_offline(tcfg, ts, _t(blocks))
        _close(to, jo)
        _assert_state_close(ts, js)
        if i == 0:
            ts = _to_port(js)


@pytest.mark.parametrize("nparts,nb", [(1, 5), (3, 2), (5, 17)])
def test_offline_matches_stream_at_any_shape(nparts, nb):
    """Shapes no TPU kernel takes (nparts < 8 or odd): the port renders
    them all on its kernel route, equal to pconv_stream, chained."""
    cfg = P.PconvConfig(pts=16, nparts=nparts)
    rng = np.random.default_rng(nparts * nb)
    st0 = _seeded(cfg, rng)
    blocks = _t(rng.standard_normal((2 * nb, 16)).astype(np.float32))
    ss, ref = P.pconv_stream(cfg, st0, blocks)
    so, a = P.pconv_offline(cfg, st0, blocks[:nb])
    so, b = P.pconv_offline(cfg, so, blocks[nb:])
    _close(torch.cat([a, b]), ref)
    _assert_state_close(so, ss)
    with pytest.raises(ValueError, match="at least one block"):
        P.pconv_offline(cfg, st0, blocks[:0])


def test_scan_free_engines_take_partitions_above_the_scan_kernels():
    """pts = 4096 (above the dense-table scan kernels' 2048): pconv_offline
    and stream_decomposed render through the transform chain and the
    sliding MAC, and pconv_stream runs the split scan, against
    float64 scipy."""
    pts, nparts, nb = 4096, 2, 3
    cfg = P.PconvConfig(pts=pts, nparts=nparts)
    rng = np.random.default_rng(4096)
    ir = rng.standard_normal(cfg.cvs).astype(np.float32)
    x = rng.standard_normal(nb * pts).astype(np.float32)
    st = P.push_ir(cfg, P.pconv_init(cfg, CPU), _t(ir))
    ref = sps.fftconvolve(x.astype(np.float64), ir.astype(np.float64))[:nb * pts]
    for fn in (P.pconv_offline, stream_decomposed, P.pconv_stream):
        _close(fn(cfg, st, _t(x.reshape(nb, pts)))[1].reshape(-1), ref, 3e-5)


@pytest.mark.parametrize("nch,route", [(3, "chunk_mac"), (17, "macflow_lti_batched")])
def test_offline_batched_matches_jax(nch, route, monkeypatch):
    """_offline_batched against the JAX one (pallas="on", interpret mode):
    up to 16 channels both go through chunk_mac, above through
    macflow_lti_batched."""
    jcfg, tcfg = _cfgs(128, 8, pallas="on")
    rng = np.random.default_rng(nch)
    ts = _seeded(tcfg, rng, nch)
    js = _to_jax(ts)
    calls = []
    real = getattr(S, route)
    monkeypatch.setattr(P, route, lambda *a: calls.append(1) or real(*a))
    for nb in (9, 4):
        blocks = (0.5 * rng.standard_normal((nb, nch, 128))).astype(np.float32)
        js, jo = J._offline_batched(jcfg, js, jnp.asarray(blocks))
        ts, to = P._offline_batched(tcfg, ts, _t(blocks))
        _close(to, jo)
        _assert_state_close(ts, js)
    assert len(calls) == 2


def test_stream_batched_chunked_matches_jax():
    """K = 4 chunks through the chunk engine (JAX pallas="macflow" forces
    it), then per-channel pointers delegate to pconv_stream_batched."""
    jcfg, tcfg = _cfgs(16, 8, pallas="macflow")
    rng = np.random.default_rng(30)
    ts = _seeded(tcfg, rng, 2)
    js = _to_jax(ts)
    blocks = rng.standard_normal((12, 2, 16)).astype(np.float32)
    js, jo = J.pconv_stream_batched_chunked(jcfg, js, jnp.asarray(blocks), K=4)
    ts, to = P.pconv_stream_batched_chunked(tcfg, ts, _t(blocks), K=4)
    _close(to, jo)
    _assert_state_close(ts, js)
    with pytest.raises(ValueError, match="multiple of K=5"):
        P.pconv_stream_batched_chunked(tcfg, ts, _t(blocks), K=5)
    vec = ts._replace(wp=(ts.wp,) * 2, wp2=(ts.wp2,) * 2)
    sv, ov = P.pconv_stream_batched_chunked(tcfg, vec, _t(blocks), K=4)
    ss, os_ = P.pconv_stream_batched(tcfg, vec, _t(blocks))
    np.testing.assert_array_equal(ov.numpy(), os_.numpy())
    assert sv.wp == ss.wp


def _steps(step, st, *ops):
    """Per-block steps over the blocks of ops, the state chained."""
    for blk in zip(*ops):
        st = step(st, *blk)[0]
    return st, None


@pytest.mark.parametrize("path", ["chunk", "chunk_tv", "offline", "render", "chunked",
                                  "decomposed", "step", "step_tv", "decomposed_tv",
                                  "tv_chunked", "split_scan"])
def test_engine_states_chain_into_the_scan(path):
    """Every path of the timeline engine, the per-block steps on a batched
    state and the batched TV scan (``split_scan``: the streams' one scan
    route, the JAX package's split kernel above pts 2048) leave contiguous
    state planes
    (the card's whole-scan kernels take no others) that chain into the scan
    as the scan's own state does."""
    cfg = P.PconvConfig(pts=16, nparts=4)
    rng = np.random.default_rng(len(path))
    nch = None if path in ("chunk", "chunk_tv", "offline", "decomposed",
                           "decomposed_tv") else 3
    st0 = _seeded(cfg, rng, nch)
    shape = (6, 16) if nch is None else (6, nch, 16)
    blocks, more = (_t(rng.standard_normal(shape).astype(np.float32)) for _ in range(2))
    run = {"chunk": lambda s: P.pconv_chunk(cfg, s, blocks[:3]),
           "chunk_tv": lambda s: P.pconv_chunk_tv(cfg, s, blocks[:3], blocks[3:]),
           "offline": lambda s: P.pconv_offline(cfg, s, blocks),
           "render": lambda s: P._offline_batched(cfg, s, blocks),
           "chunked": lambda s: P.pconv_stream_batched_chunked(cfg, s, blocks, K=2),
           "decomposed": lambda s: stream_decomposed(cfg, s, blocks),
           "step": lambda s: _steps(lambda s_, b: P.pconv_step(cfg, s_, b), s, blocks[:3]),
           "step_tv": lambda s: _steps(lambda s_, x, h: P.pconv_step_tv(cfg, s_, x, h), s,
                                       blocks[:3], blocks[3:]),
           "decomposed_tv": lambda s: stream_decomposed(cfg, s, blocks[:3], blocks[3:]),
           "tv_chunked": lambda s: P.pconv_stream_batched_tv_chunked(cfg, s, blocks[:3],
                                                                     blocks[3:], K=1),
           "split_scan": lambda s: P.pconv_stream_batched_tv(cfg, s, blocks[:3], blocks[3:])}[path]
    st = run(st0)[0]
    for name in RINGS + ("tail",):
        assert getattr(st, name).is_contiguous(), name
    scan = P.pconv_stream if nch is None else P.pconv_stream_batched
    if path in ("chunk_tv", "step_tv", "decomposed_tv", "tv_chunked", "split_scan"):
        scan_tv = P.pconv_stream_tv if nch is None else P.pconv_stream_batched_tv
        ref = scan_tv(cfg, st0, blocks[:3], blocks[3:])[0]
    else:
        ref = scan(cfg, st0, blocks[:3] if path in ("chunk", "step") else blocks)[0]
    _assert_state_close(st, ref)
    _close(scan(cfg, st, more)[1], scan(cfg, ref, more)[1])


# ---------------------------------------------------------------------------
# convolve_oneshot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nx,nh", [(1000, 300), (100, 5000), (333, 77)])
def test_oneshot_matches_scipy_and_jax(nx, nh):
    rng = np.random.default_rng(nx + nh)
    x = rng.standard_normal(nx).astype(np.float32)
    h = rng.standard_normal(nh).astype(np.float32)
    got = P.convolve_oneshot(_t(x), _t(h))
    ref = sps.fftconvolve(x.astype(np.float64), h.astype(np.float64))
    _close(got, ref, 3e-5)
    _close(got, J.convolve_oneshot(x, h))
    _close(P.convolve_oneshot(x, h, device=CPU), got)
    with pytest.raises(ValueError, match="convolve_oneshot: pass device="):
        P.convolve_oneshot(x, h)


# ---------------------------------------------------------------------------
# stream_decomposed (LTI)
# ---------------------------------------------------------------------------

def test_stream_decomposed_matches_jax_macflow_route():
    """JAX pallas="macflow" runs macflow_lti in interpret mode; chained
    calls of 24 and 5 blocks with the state crossing JAX -> port."""
    jcfg, tcfg = _cfgs(128, 16, pallas="macflow")
    rng = np.random.default_rng(40)
    ts = _seeded(tcfg, rng)
    js = _to_jax(ts)
    for i, nb in enumerate((24, 5)):
        blocks = rng.standard_normal((nb, 128)).astype(np.float32)
        js, jo = JD.stream_decomposed(jcfg, js, jnp.asarray(blocks))
        ts, to = stream_decomposed(tcfg, ts, _t(blocks))
        _close(to, jo)
        _assert_state_close(ts, js)
        if i == 0:
            ts = _to_port(js)


@pytest.mark.parametrize("nparts,nb", [(3, 2), (4, 11)])
def test_stream_decomposed_matches_pconv_stream(nparts, nb):
    cfg = P.PconvConfig(pts=16, nparts=nparts)
    rng = np.random.default_rng(nparts + nb)
    st0 = _seeded(cfg, rng)
    blocks = _t(rng.standard_normal((nb, 16)).astype(np.float32))
    ss, ref = P.pconv_stream(cfg, st0, blocks)
    sd, got = stream_decomposed(cfg, st0, blocks)
    _close(got, ref)
    _assert_state_close(sd, ss)
    before = S.MACFLOW_LAUNCHES
    s0, empty = stream_decomposed(cfg, st0, blocks[:0])
    assert empty.shape == (0, 16) and s0 is st0 and S.MACFLOW_LAUNCHES == before



# ---------------------------------------------------------------------------
# the serving model
# ---------------------------------------------------------------------------

def _convolvers(pts, nparts, nch, rng):
    jcfg, tcfg = J.PconvConfig.for_ir_length(pts * nparts, pts), P.PconvConfig(pts=pts,
                                                                                nparts=nparts)
    irs = (0.3 * rng.standard_normal((nch, pts * nparts))).astype(np.float32)
    conv, jconv = M.Convolver(tcfg, nch, device=CPU), JM.Convolver(jcfg, nch)
    conv.push_ir(irs)
    jconv.push_ir(irs)
    return conv, jconv, irs


def test_convolver_render_matches_jax_and_scipy():
    rng = np.random.default_rng(50)
    conv, jconv, irs = _convolvers(32, 4, 3, rng)
    x = rng.standard_normal((3, 20 * 32)).astype(np.float32)
    blocks = np.ascontiguousarray(x.reshape(3, 20, 32).transpose(1, 0, 2))
    got = torch.cat([conv.render(blocks[:7]), conv.render(blocks[7:])])
    ref = np.concatenate([np.asarray(jconv.render(blocks[:7])),
                          np.asarray(jconv.render(blocks[7:]))])
    _close(got, ref)
    _assert_state_close(conv.state, jconv.state)
    for c in range(3):
        _close(got[:, c].reshape(-1), sps.fftconvolve(x[c], irs[c])[:640], 3e-5)


@pytest.mark.parametrize("chunk", [2, 4])
def test_convolver_chunked_stream_bitwise_equals_steps(chunk):
    """stream(chunk=K) equals per-block step() calls exactly and the JAX
    chunked stream within tolerance."""
    rng = np.random.default_rng(60 + chunk)
    conv, jconv, _ = _convolvers(16, 4, 2, rng)
    stepper = M.Convolver(conv.cfg, 2, device=CPU)
    stepper.state = conv.state
    blocks = rng.standard_normal((12, 2, 16)).astype(np.float32)
    got = conv.stream(blocks, chunk=chunk)
    np.testing.assert_array_equal(got.numpy(),
                                  torch.stack([stepper.step(b) for b in blocks]).numpy())
    _assert_state_equal(conv.state, stepper.state)
    _close(got, jconv.stream(jnp.asarray(blocks), chunk=chunk))
    with pytest.raises(ValueError, match="multiple of chunk 5"):
        conv.stream(blocks, chunk=5)
    with pytest.raises(ValueError, match="chunk size must be in"):
        conv.stream(np.zeros((6, 2, 16), np.float32), chunk=6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the sliding-MAC kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nch", [1, 3, 17])
def test_cuda_offline_paths_match_cpu(cuda_device, nch):
    """The offline paths on the card (the sliding-MAC kernel) against the
    same paths on the CPU (its twin), one channel or batched."""
    cfg = P.PconvConfig(pts=64, nparts=5)
    rng = np.random.default_rng(70 + nch)
    st = _seeded(cfg, rng, None if nch == 1 else nch)
    st_d = P.PconvState(*(f.to(cuda_device) if isinstance(f, torch.Tensor) else f
                          for f in st))
    shape = (21, 64) if nch == 1 else (21, nch, 64)
    blocks = _t(rng.standard_normal(shape).astype(np.float32))
    if nch == 1:
        fns = (P.pconv_offline, stream_decomposed)
    else:
        fns = (P._offline_batched,
               lambda c, s, b: P.pconv_stream_batched_chunked(c, s, b, K=7))
    for fn in fns:
        s_cpu, o_cpu = fn(cfg, st, blocks)
        s_gpu, o_gpu = fn(cfg, st_d, blocks.to(cuda_device))
        torch.cuda.synchronize()
        _close(o_gpu, o_cpu, 2e-5)
        _assert_state_close(s_gpu, s_cpu)
