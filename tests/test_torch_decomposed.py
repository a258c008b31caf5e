"""Port parity: the time-varying (TV) decomposed engine of
opencl_fft_tpu_torch (``ops/decomposed.py``: ``stream_decomposed`` with
``blocks_h``, ``stream_batched_tv_decomposed``; ``ops/pconv.py``:
``pconv_stream_batched_tv_chunked``; ``TVConvolver.stream_chunked``)
against the port's own sequential scan and against opencl_fft_tpu.

These are the TV cases of the JAX package's ``tests/test_decomposed.py``:
the engine matches the scan, chained calls match one call, compat bin 0,
the batched chunked engine matches the scan, and calls that start at a
ring phase off the JAX kernel's 8-row alignment. Each is also held
against the JAX function on the same numpy-seeded inputs, the state
crossing packages through ``interop.py`` (outputs atol 2e-5 * max|ref|,
3e-5 across chained calls, rings 1e-5 * max|ring|; the paths sum the
partitions in different float32 orders). JAX ``pallas="macflow"`` runs its
``macflow_tv{,_batched}`` kernels in interpret mode (phase c = 0 mod 8)
and its gather evaluation at other phases; the port runs its twin at every
phase. The CUDA kernels are held against the twins on a card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_fft_tpu.models import convolver as JM
from opencl_fft_tpu.ops import decomposed as JD
from opencl_fft_tpu.ops import pconv as J
from opencl_fft_tpu_torch import models as M
from opencl_fft_tpu_torch.interop import pconv_state_from_numpy, pconv_state_to_numpy
from opencl_fft_tpu_torch.ops import pconv as P
from opencl_fft_tpu_torch.ops.cuda import slidemac as S
from opencl_fft_tpu_torch.ops.decomposed import stream_batched_tv_decomposed, stream_decomposed

torch.set_num_threads(1)

CPU = "cpu"
RINGS = ("spec_x_re", "spec_x_im", "spec_h_re", "spec_h_im")


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, ref, rel=2e-5):
    ref, got = _np(ref), _np(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=rel * (np.abs(ref).max() + 1e-30), rtol=0)


def _assert_state_close(got, ref):
    for name in RINGS:
        _close(getattr(got, name), getattr(ref, name), 1e-5)
    _close(got.tail, ref.tail)
    for name in ("wp", "wp2"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(ref, name)), err_msg=name)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _to_jax(state):
    return J.PconvState(**{k: jnp.asarray(v) for k, v in pconv_state_to_numpy(state).items()})


def _to_port(jstate):
    return pconv_state_from_numpy(J.PconvState(*map(np.asarray, jstate)), CPU)


def _mk(pts, nparts, seed, nch=None, **kw):
    """A port config and state with a pushed IR, the JAX config, and the
    rng (``nch`` channels when given)."""
    cfg = P.PconvConfig(pts=pts, nparts=nparts, **kw)
    rng = np.random.default_rng(seed)
    shape = (cfg.cvs,) if nch is None else (nch, cfg.cvs)
    ir = (0.3 * rng.standard_normal(shape)).astype(np.float32)
    st = P.pconv_init(cfg, CPU) if nch is None else M.batched_state(cfg, nch, CPU)
    return cfg, J.PconvConfig(pts=pts, nparts=nparts, **kw), P.push_ir(cfg, st, _t(ir)), rng


def _operands(rng, *shape):
    return (rng.standard_normal(shape).astype(np.float32),
            (0.2 * rng.standard_normal(shape)).astype(np.float32))


@pytest.mark.parametrize("nparts,nb", [(16, 40), (16, 7), (8, 64), (32, 12), (16, 3)])
def test_decomposed_tv_matches_scan_and_jax(nparts, nb):
    cfg, jcfg, st, rng = _mk(64, nparts, seed=nparts + nb)
    bx, bh = _operands(rng, nb, 64)
    ss, ref = P.pconv_stream_tv(cfg, st, _t(bx), _t(bh))
    before = S.MACFLOW_TV_LAUNCHES
    sd, got = stream_decomposed(cfg, st, _t(bx), _t(bh))
    assert S.MACFLOW_TV_LAUNCHES == before          # the CPU runs the twin
    _close(got, ref)
    _assert_state_close(sd, ss)
    js, jout = JD.stream_decomposed(jcfg, _to_jax(st), jnp.asarray(bx), jnp.asarray(bh))
    _close(got, jout)
    _assert_state_close(sd, js)


def test_decomposed_tv_chaining_matches_one_call_and_jax():
    """21 + 16 blocks chained (the second call at a mid-stream wp/wp2)
    against one scan, the state crossing port -> JAX -> port."""
    cfg, jcfg, st, rng = _mk(128, 16, seed=2)
    bx, bh = _operands(rng, 37, 128)
    _, ref = P.pconv_stream_tv(cfg, st, _t(bx), _t(bh))
    sa, oa = stream_decomposed(cfg, st, _t(bx[:21]), _t(bh[:21]))
    jcfg = dataclasses.replace(jcfg, pallas="macflow")
    jb, ob = JD.stream_decomposed(jcfg, _to_jax(sa), jnp.asarray(bx[21:]),
                                  jnp.asarray(bh[21:]))
    sb, ob_port = stream_decomposed(cfg, _to_port(_to_jax(sa)), _t(bx[21:]), _t(bh[21:]))
    _close(torch.cat([oa, ob_port]), ref, 3e-5)
    _close(ob_port, ob)
    _assert_state_close(sb, jb)
    # and the other way: a JAX first half into the port
    ja, joa = JD.stream_decomposed(jcfg, _to_jax(st), jnp.asarray(bx[:16]), jnp.asarray(bh[:16]))
    _, o2 = stream_decomposed(cfg, _to_port(ja), _t(bx[16:]), _t(bh[16:]))
    _close(torch.cat([_t(np.asarray(joa)), o2]), ref, 3e-5)


@pytest.mark.parametrize("steps", [3, 5])
def test_decomposed_tv_off_phase_chaining(steps):
    """A call starting after ``steps`` per-block steps (ring phase off the
    JAX kernel's 8-row alignment), then a second call: against the scan and
    JAX (its gather route at these phases)."""
    cfg, jcfg, st, rng = _mk(128, 16, seed=10 + steps)
    bx, bh = _operands(rng, steps + 24, 128)
    for i in range(steps):
        st = P.pconv_step_tv(cfg, st, _t(bx[i]), _t(bh[i]))[0]
    assert (cfg.nparts - 1 - st.wp2) % cfg.nparts % 8
    _, ref = P.pconv_stream_tv(cfg, st, _t(bx[steps:]), _t(bh[steps:]))
    sa, oa = stream_decomposed(cfg, st, _t(bx[steps:steps + 11]), _t(bh[steps:steps + 11]))
    sb, ob = stream_decomposed(cfg, sa, _t(bx[steps + 11:]), _t(bh[steps + 11:]))
    _close(torch.cat([oa, ob]), ref, 3e-5)
    jcfg = dataclasses.replace(jcfg, pallas="macflow")
    js, jo = JD.stream_decomposed(jcfg, _to_jax(st), jnp.asarray(bx[steps:steps + 11]),
                                  jnp.asarray(bh[steps:steps + 11]))
    _close(oa, jo)
    _assert_state_close(sa, js)


def test_decomposed_tv_compat_bin0():
    cfg, jcfg, st, rng = _mk(64, 16, seed=4, bin0_mode="compat")
    bx, bh = _operands(rng, 24, 64)
    _, ref = P.pconv_stream_tv(cfg, st, _t(bx), _t(bh))
    _, got = stream_decomposed(cfg, st, _t(bx), _t(bh))
    _close(got, ref)
    _close(got, JD.stream_decomposed(jcfg, _to_jax(st), jnp.asarray(bx), jnp.asarray(bh))[1])


@pytest.mark.parametrize("nparts", [1, 3])
def test_decomposed_tv_small_rings(nparts):
    """nparts below the kernel's two-row MAC path, nb below and above
    nparts."""
    cfg, _, st, rng = _mk(16, nparts, seed=nparts)
    for nb in (1, nparts + 4):
        bx, bh = _operands(rng, nb, 16)
        ss, ref = P.pconv_stream_tv(cfg, st, _t(bx), _t(bh))
        sd, got = stream_decomposed(cfg, st, _t(bx), _t(bh))
        _close(got, ref)
        _assert_state_close(sd, ss)


def test_batched_tv_decomposed_matches_scan_and_jax():
    cfg, jcfg, st, rng = _mk(128, 16, seed=20, nch=3)
    bx, bh = _operands(rng, 12, 3, 128)
    ss, ref = P.pconv_stream_batched_tv(cfg, st, _t(bx), _t(bh))
    before = S.MACFLOW_TV_BATCHED_LAUNCHES
    sd, got = stream_batched_tv_decomposed(cfg, st, _t(bx), _t(bh))
    assert S.MACFLOW_TV_BATCHED_LAUNCHES == before
    _close(got, ref)
    _assert_state_close(sd, ss)
    js, jo = JD.stream_batched_tv_decomposed(dataclasses.replace(jcfg, pallas="macflow"),
                                             _to_jax(st), jnp.asarray(bx), jnp.asarray(bh))
    _close(got, jo)
    _assert_state_close(sd, js)
    with pytest.raises(ValueError, match="shared by every channel"):
        stream_batched_tv_decomposed(cfg, st._replace(wp2=(1, 2, 3)), _t(bx), _t(bh))
    s0, empty = stream_batched_tv_decomposed(cfg, st, _t(bx[:0]), _t(bh[:0]))
    assert empty.shape == (0, 3, 128) and s0 is st


@pytest.mark.parametrize("K,steps", [(8, 0), (4, 3)])
def test_tv_chunked_matches_scan_and_jax(K, steps):
    """pconv_stream_batched_tv_chunked against the batched scan and the JAX
    chunked engine (pallas="macflow": its kernel in interpret mode at the
    aligned phase, its gathers off phase), after ``steps`` per-block steps."""
    cfg, jcfg, st, rng = _mk(128, 16, seed=30 + K, nch=2)
    bx, bh = _operands(rng, steps + 16, 2, 128)
    for i in range(steps):
        st = P.pconv_step_tv(cfg, st, _t(bx[i]), _t(bh[i]))[0]
    bx, bh = bx[steps:], bh[steps:]
    ss, ref = P.pconv_stream_batched_tv(cfg, st, _t(bx), _t(bh))
    sc, got = P.pconv_stream_batched_tv_chunked(cfg, st, _t(bx), _t(bh), K=K)
    _close(got, ref)
    _assert_state_close(sc, ss)
    js, jo = J.pconv_stream_batched_tv_chunked(dataclasses.replace(jcfg, pallas="macflow"),
                                               _to_jax(st), jnp.asarray(bx), jnp.asarray(bh),
                                               K=K)
    _close(got, jo)
    _assert_state_close(sc, js)


def test_tv_chunked_routes_and_validates():
    cfg, _, st, rng = _mk(16, 4, seed=40, nch=2)
    bx, bh = _operands(rng, 8, 2, 16)
    with pytest.raises(ValueError, match="multiple of K=3"):
        P.pconv_stream_batched_tv_chunked(cfg, st, _t(bx), _t(bh), K=3)
    with pytest.raises(ValueError, match="blocks_h"):
        P.pconv_stream_batched_tv_chunked(cfg, st, _t(bx), _t(bh[:4]), K=4)
    # per-channel pointers go to the batched scan
    per = st._replace(wp=(0, 1), wp2=(3, 2))
    before = S.MACFLOW_TV_BATCHED_LAUNCHES
    sp, got = P.pconv_stream_batched_tv_chunked(cfg, per, _t(bx), _t(bh), K=4)
    sr, ref = P.pconv_stream_batched_tv(cfg, per, _t(bx), _t(bh))
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert (sp.wp, sp.wp2) == (sr.wp, sr.wp2) and S.MACFLOW_TV_BATCHED_LAUNCHES == before
    s0, empty = P.pconv_stream_batched_tv_chunked(cfg, st, _t(bx[:0]), _t(bh[:0]))
    assert empty.shape == (0, 2, 16) and s0 is st


def test_tv_convolver_stream_chunked_matches_stream_and_jax():
    """TVConvolver.stream_chunked after 3 step() calls (off phase), then
    stream(): against an engine that only streams, and the JAX class."""
    pts, nparts, nch = 128, 8, 2
    cfg = P.PconvConfig(pts=pts, nparts=nparts)
    jcfg = J.PconvConfig(pts=pts, nparts=nparts, pallas="macflow")
    rng = np.random.default_rng(50)
    bx, bh = _operands(rng, 3 + 16 + 4, nch, pts)
    tv, ref, jtv = (M.TVConvolver(cfg, nch, device=CPU), M.TVConvolver(cfg, nch, device=CPU),
                    JM.TVConvolver(jcfg, nch))
    for i in range(3):
        tv.step(bx[i], bh[i])
        ref.step(bx[i], bh[i])
        jtv.step(jnp.asarray(bx[i]), jnp.asarray(bh[i]))
    got = tv.stream_chunked(bx[3:19], bh[3:19], K=8)
    _close(got, ref.stream(bx[3:19], bh[3:19]))
    _close(got, jtv.stream_chunked(jnp.asarray(bx[3:19]), jnp.asarray(bh[3:19]), K=8))
    _close(tv.stream(bx[19:], bh[19:]), ref.stream(bx[19:], bh[19:]))


def test_decomposed_validates():
    cfg, _, st, _ = _mk(16, 4, seed=60)
    z = torch.zeros
    with pytest.raises(ValueError, match="blocks_h"):
        stream_decomposed(cfg, st, z((3, 16)), z((2, 16)))
    with pytest.raises(ValueError, match="blocks_x must be"):
        stream_decomposed(cfg, st, z((3, 8)), z((3, 8)))
    s0, empty = stream_decomposed(cfg, st, z((0, 16)), z((0, 16)))
    assert empty.shape == (0, 16) and s0 is st


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the TV sliding-MAC kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [0, 3])
def test_cuda_tv_decomposed_paths_match_cpu(cuda_device, steps):
    """The TV decomposed paths on the card (the TV sliding-MAC kernel)
    against the same paths on the CPU (its twin)."""
    cfg, _, st, rng = _mk(64, 5, seed=70 + steps, nch=3)
    bx, bh = _operands(rng, steps + 14, 3, 64)
    for i in range(steps):
        st = P.pconv_step_tv(cfg, st, _t(bx[i]), _t(bh[i]))[0]
    bx, bh = _t(bx[steps:]), _t(bh[steps:])
    st_d = P.PconvState(*(f.to(cuda_device) if isinstance(f, torch.Tensor) else f
                          for f in st))
    one = P.PconvState(*(f[0] if isinstance(f, torch.Tensor) else f for f in st))
    one_d = P.PconvState(*(f.to(cuda_device) if isinstance(f, torch.Tensor) else f
                           for f in one))
    runs = ((lambda s, x, h: P.pconv_stream_batched_tv_chunked(cfg, s, x, h, K=7), st, st_d,
             bx, bh),
            (lambda s, x, h: stream_decomposed(cfg, s, x, h), one, one_d, bx[:, 0], bh[:, 0]))
    for fn, s_cpu, s_gpu, x, h in runs:
        c_state, c_out = fn(s_cpu, x, h)
        g_state, g_out = fn(s_gpu, x.to(cuda_device), h.to(cuda_device))
        torch.cuda.synchronize()
        _close(g_out, c_out)
        _assert_state_close(g_state, c_state)
