"""Port parity: the bf16-ring and float64 engine options of
opencl_fft_tpu_torch against opencl_fft_tpu on the same inputs.

Ports of the ``tests/test_f64.py`` cases and of the bf16 cases of
``tests/test_pconv.py`` / ``tests/test_models.py``, each also held against
the JAX function on the same seeded inputs:

- float64: pconv_stream and dconv_stream against float64 numpy at 1e-12 of
  max|ref| (the JAX bound) and against the JAX x64 route at 1e-12 of
  max|JAX|; states cross packages both ways.
- bf16 rings: against scipy at 5e-3 of max|ref| (the JAX bound) and against
  the JAX bf16 route at 2e-3 of max|JAX|: both packages compute the float32
  frames with other reduction orders, so a few ring entries round to a
  neighbouring bf16 value (one bf16 ulp is 2^-8 of an entry). Inside the
  port, chunks are bit-equal to sequential steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import enable_x64
from scipy import signal as sps

from opencl_fft_tpu.models import convolver as JM
from opencl_fft_tpu.ops import dconv as JD
from opencl_fft_tpu.ops import decomposed as JDC
from opencl_fft_tpu.ops import pconv as J
from opencl_fft_tpu_torch import models as M
from opencl_fft_tpu_torch.interop import (dconv_state_from_numpy, dconv_state_to_numpy,
                                          pconv_state_from_numpy, pconv_state_to_numpy,
                                          xfade_state_from_numpy, xfade_state_to_numpy)
from opencl_fft_tpu_torch.ops import dconv as D
from opencl_fft_tpu_torch.ops import decomposed as DC
from opencl_fft_tpu_torch.ops import pconv as P

torch.set_num_threads(1)

RNG = np.random.default_rng(7)
F64_TOL = 1e-12
BF16_SCIPY_TOL = 5e-3
BF16_JAX_TOL = 2e-3


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _np(state):
    """A JAX state's fields as numpy: bf16 planes widened to float32."""
    return {k: (np.asarray(v, np.float32) if np.asarray(v).dtype.name == "bfloat16"
                else np.asarray(v)) for k, v in state._asdict().items()}


# ---------------------------------------------------------------- float64

def test_pconv_f64_matches_numpy_tight():
    x = RNG.standard_normal(2048)
    h = RNG.standard_normal(512)
    cfg = P.PconvConfig.for_ir_length(512, 64, dtype="f64")
    st = P.push_ir(cfg, P.pconv_init(cfg, "cpu"), torch.from_numpy(h))
    assert st.spec_h_re.dtype == torch.float64
    _, out = P.pconv_stream(cfg, st, torch.from_numpy(x.reshape(-1, 64)))
    got = out.reshape(-1).numpy()
    assert got.dtype == np.float64
    assert _rel(got, np.convolve(x, h)[:got.size]) <= F64_TOL
    with enable_x64():
        jcfg = J.PconvConfig.for_ir_length(512, 64, dtype="f64")
        jst = J.push_ir(jcfg, J.pconv_init(jcfg), h)
        _, jout = J.pconv_stream(jcfg, jst, x.reshape(-1, 64))
        jout = np.asarray(jout).reshape(-1)
    assert _rel(got, jout) <= F64_TOL


def test_dconv_f64_matches_numpy_tight():
    x = RNG.standard_normal(1024)
    h = RNG.standard_normal(128)
    cfg = D.DconvConfig(irsize=128, vsize=64, dtype="f64")
    st = D.push_ir(cfg, D.dconv_init(cfg, "cpu"), torch.from_numpy(h))
    _, out = D.dconv_stream(cfg, st, torch.from_numpy(x.reshape(-1, 64)))
    got = out.reshape(-1).numpy()
    assert got.dtype == np.float64
    assert _rel(got, np.convolve(x, h)[:got.size]) <= F64_TOL
    with enable_x64():
        jcfg = JD.DconvConfig(irsize=128, vsize=64, dtype="f64")
        _, jout = JD.dconv_stream(jcfg, JD.push_ir(jcfg, JD.dconv_init(jcfg), h),
                                  x.reshape(-1, 64))
        jout = np.asarray(jout).reshape(-1)
    assert _rel(got, jout) <= F64_TOL


def test_f64_rejects_reduced_ring():
    with pytest.raises(ValueError):
        P.PconvConfig(pts=16, nparts=4, dtype="f64", ring_dtype="bf16")


@pytest.mark.parametrize("tv", [False, True])
def test_pconv_f64_state_crosses_from_jax(tv):
    """A JAX x64 stream handed to the port mid-stream (and back) continues
    as the JAX stream does, to 1e-12; the state stays float64."""
    pts, nparts = 32, 8
    bx = RNG.standard_normal((20, pts))
    bh = RNG.standard_normal((20, pts))
    h = RNG.standard_normal(pts * nparts)
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts, dtype="f64")
    with enable_x64():
        jcfg = J.PconvConfig.for_ir_length(pts * nparts, pts, dtype="f64")
        jst = J.push_ir(jcfg, J.pconv_init(jcfg), h)
        if tv:
            jst, _ = J.pconv_stream_tv(jcfg, jst, bx[:9], bh[:9])
            mid = _np(jst)
            jst, jout = J.pconv_stream_tv(jcfg, jst, bx[9:], bh[9:])
        else:
            jst, _ = J.pconv_stream(jcfg, jst, bx[:9])
            mid = _np(jst)
            jst, jout = J.pconv_stream(jcfg, jst, bx[9:])
        jout, jend = np.asarray(jout), _np(jst)
    st = pconv_state_from_numpy(mid, "cpu", cfg)
    assert st.spec_x_re.dtype == torch.float64 and st.tail.dtype == torch.float64
    if tv:
        st, out = P.pconv_stream_tv(cfg, st, torch.from_numpy(bx[9:]), torch.from_numpy(bh[9:]))
    else:
        st, out = P.pconv_stream(cfg, st, torch.from_numpy(bx[9:]))
    assert _rel(out.numpy(), jout) <= F64_TOL
    back = pconv_state_to_numpy(st)
    for name in ("spec_x_re", "spec_x_im", "spec_h_re", "spec_h_im", "tail"):
        assert back[name].dtype == np.float64
        np.testing.assert_allclose(back[name], jend[name],
                                   atol=F64_TOL * np.abs(jend[name]).max(), rtol=0)
    assert (int(back["wp"]), int(back["wp2"])) == (int(jend["wp"]), int(jend["wp2"]))


def test_dconv_f64_state_crosses_from_jax():
    cfg = D.DconvConfig(irsize=100, vsize=32, dtype="f64")
    x = RNG.standard_normal((12, 32))
    h = RNG.standard_normal(100)
    with enable_x64():
        jcfg = JD.DconvConfig(irsize=100, vsize=32, dtype="f64")
        jst, _ = JD.dconv_stream(jcfg, JD.push_ir(jcfg, JD.dconv_init(jcfg), h), x[:5])
        mid = _np(jst)
        _, jout = JD.dconv_stream(jcfg, jst, x[5:])
        jout = np.asarray(jout)
    st = dconv_state_from_numpy(mid, "cpu", cfg)
    assert st.delay.dtype == torch.float64
    st, out = D.dconv_stream(cfg, st, torch.from_numpy(x[5:]))
    assert _rel(out.numpy(), jout) <= F64_TOL
    again = dconv_state_from_numpy(dconv_state_to_numpy(st), "cpu", cfg)
    assert torch.equal(again.delay, st.delay) and torch.equal(again.coefs, st.coefs)


def test_f64_chunk_offline_and_models_match_numpy():
    """Every float64 entry point stays float64 and tight: pconv_chunk,
    pconv_offline, the decomposed engine, Convolver.render and step, and
    dconv_step, against float64 numpy."""
    pts, nparts, nch = 16, 4, 2
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts, dtype="f64")
    irs = RNG.standard_normal((nch, cfg.cvs))
    x = RNG.standard_normal((12, nch, pts))
    refs = [np.convolve(x[:, c].reshape(-1), irs[c])[:12 * pts] for c in range(nch)]
    st = P.push_ir(cfg, P.pconv_init(cfg, "cpu"), torch.from_numpy(irs[0]))
    blocks = torch.from_numpy(x[:, 0])
    s_, chunks = st, []
    for i in range(0, 12, 4):
        s_, o = P.pconv_chunk(cfg, s_, blocks[i:i + 4])
        chunks.append(o)
    outs = {"offline": P.pconv_offline(cfg, st, blocks)[1],
            "decomposed": DC.stream_decomposed(cfg, st, blocks)[1],
            "chunk": torch.cat(chunks)}
    for name, out in outs.items():
        assert out.dtype == torch.float64, name
        got = out.reshape(-1).numpy()
        assert _rel(got, refs[0][:got.size]) <= F64_TOL, name
    conv = M.Convolver(cfg, nch, device="cpu")
    conv.push_ir(irs)
    y = torch.cat([conv.render(x[:6]), torch.stack([conv.step(b) for b in x[6:]])])
    for c in range(nch):
        assert _rel(y[:, c].reshape(-1).numpy(), refs[c]) <= F64_TOL
    dcfg = D.DconvConfig(irsize=20, vsize=8, dtype="f64")
    dst = D.push_ir(dcfg, D.dconv_init(dcfg, "cpu"), torch.from_numpy(irs[0, :20]))
    xs = RNG.standard_normal((5, 8))
    got = []
    for b in xs:
        dst, o = D.dconv_step(dcfg, dst, torch.from_numpy(b))
        got.append(o.numpy())
    assert _rel(np.concatenate(got), np.convolve(xs.reshape(-1), irs[0, :20])[:40]) <= F64_TOL


# ------------------------------------------------------------ bf16 rings

def test_bf16_ring_mode():
    x = RNG.standard_normal(4096).astype(np.float32)
    h = RNG.standard_normal(1024).astype(np.float32)
    ref = sps.fftconvolve(x, h)
    cfg = P.PconvConfig.for_ir_length(1024, 128, ring_dtype="bf16")
    st = P.push_ir(cfg, P.pconv_init(cfg, "cpu"), torch.from_numpy(h))
    assert st.spec_h_re.dtype == torch.bfloat16 and st.tail.dtype == torch.float32
    st, out = P.pconv_stream(cfg, st, torch.from_numpy(x.reshape(-1, 128)))
    got = out.reshape(-1).numpy()
    assert _rel(got, ref[:got.size]) < BF16_SCIPY_TOL
    assert st.spec_x_re.dtype == torch.bfloat16
    jcfg = J.PconvConfig.for_ir_length(1024, 128, ring_dtype="bf16")
    _, jout = J.pconv_stream(jcfg, J.push_ir(jcfg, J.pconv_init(jcfg), jnp.asarray(h)),
                             jnp.asarray(x.reshape(-1, 128)))
    assert _rel(got, np.asarray(jout).reshape(-1)) < BF16_JAX_TOL
    with pytest.raises(ValueError):
        P.PconvConfig(pts=16, nparts=2, ring_dtype="fp4")


def _chunk_vs_steps(k, ring, tv):
    pts, nparts = 32, 8
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts, ring_dtype=ring)
    ir = torch.from_numpy(RNG.standard_normal(cfg.cvs).astype(np.float32))
    bx = torch.from_numpy(RNG.standard_normal((24, pts)).astype(np.float32))
    bh = torch.from_numpy(RNG.standard_normal((24, pts)).astype(np.float32))
    st = P.pconv_init(cfg, "cpu") if tv else P.push_ir(cfg, P.pconv_init(cfg, "cpu"), ir)
    st2 = st
    seq = []
    for i in range(24):
        st, o = P.pconv_step_tv(cfg, st, bx[i], bh[i]) if tv else P.pconv_step(cfg, st, bx[i])
        seq.append(o)
    outs = []
    for i in range(0, 24, k):
        st2, o = (P.pconv_chunk_tv(cfg, st2, bx[i:i + k], bh[i:i + k]) if tv
                  else P.pconv_chunk(cfg, st2, bx[i:i + k]))
        outs.append(o)
    got = torch.cat(outs)
    assert torch.equal(got, torch.stack(seq))
    for name in P._PLANES:
        assert torch.equal(getattr(st2, name), getattr(st, name)), name
    # the JAX package's chunk on the same inputs
    jcfg = J.PconvConfig.for_ir_length(pts * nparts, pts, ring_dtype=ring)
    jst = J.pconv_init(jcfg) if tv else J.push_ir(jcfg, J.pconv_init(jcfg), ir.numpy())
    jouts = []
    for i in range(0, 24, k):
        jst, o = (J.pconv_chunk_tv(jcfg, jst, bx[i:i + k].numpy(), bh[i:i + k].numpy()) if tv
                  else J.pconv_chunk(jcfg, jst, bx[i:i + k].numpy()))
        jouts.append(np.asarray(o))
    assert _rel(got.numpy(), np.concatenate(jouts)) < (BF16_JAX_TOL if ring == "bf16" else 2e-5)


@pytest.mark.parametrize("k,ring", [(1, "f32"), (3, "f32"), (8, "f32"),
                                    (3, "bf16"), (8, "bf16")])
def test_chunk_bitwise_equals_sequential(k, ring):
    _chunk_vs_steps(k, ring, tv=False)


@pytest.mark.parametrize("k,ring", [(1, "f32"), (3, "f32"), (8, "f32"),
                                    (3, "bf16"), (8, "bf16")])
def test_chunk_tv_bitwise_equals_sequential(k, ring):
    _chunk_vs_steps(k, ring, tv=True)


def test_batched_state_honors_ring_dtype():
    cfg = P.PconvConfig.for_ir_length(64, 16, ring_dtype="bf16")
    st = M.batched_state(cfg, 3, "cpu")
    assert st.spec_x_re.dtype == torch.bfloat16
    assert st.spec_h_im.dtype == torch.bfloat16
    assert st.tail.dtype == torch.float32
    cfg32 = P.PconvConfig.for_ir_length(64, 16)
    assert M.batched_state(cfg32, 3, "cpu").spec_x_re.dtype == torch.float32
    cfg64 = P.PconvConfig.for_ir_length(64, 16, dtype="f64")
    st64 = M.batched_state(cfg64, 3, "cpu")
    assert st64.spec_x_re.dtype == torch.float64 and st64.tail.dtype == torch.float64


def test_bf16_models_match_jax_and_scipy():
    """Convolver.stream, stream(chunk=4), render and step, and TVConvolver
    with bf16 rings: against the JAX models and scipy; the chunked stream
    bit-equal to the steps."""
    pts, nparts, nch = 32, 8, 3
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts, ring_dtype="bf16")
    jcfg = J.PconvConfig.for_ir_length(pts * nparts, pts, ring_dtype="bf16")
    irs = (RNG.standard_normal((nch, cfg.cvs)) * 0.2).astype(np.float32)
    x = RNG.standard_normal((16, nch, pts)).astype(np.float32)
    got = {}
    for how in ("stream", "chunk", "render", "step"):
        conv = M.Convolver(cfg, nch, device="cpu")
        conv.push_ir(irs)
        got[how] = (conv.stream(x) if how == "stream" else conv.stream(x, chunk=4)
                    if how == "chunk" else conv.render(x) if how == "render"
                    else torch.stack([conv.step(b) for b in x])).numpy()
        assert conv.state.spec_x_re.dtype == torch.bfloat16
    assert np.array_equal(got["chunk"], got["step"])
    jconv = JM.Convolver(jcfg, nch)
    jconv.push_ir(jnp.asarray(irs))
    jout = np.asarray(jconv.stream(jnp.asarray(x)))
    for how, y in got.items():
        assert _rel(y, jout) < BF16_JAX_TOL, how
        for c in range(nch):
            ref = sps.fftconvolve(x[:, c].reshape(-1), irs[c])[:16 * pts]
            assert _rel(y[:, c].reshape(-1), ref) < BF16_SCIPY_TOL, (how, c)
    tv = M.TVConvolver(cfg, nch, device="cpu")
    jtv = JM.TVConvolver(jcfg, nch)
    bh = (0.3 * x[::-1]).copy()
    y = tv.stream(x, bh).numpy()
    assert _rel(y, np.asarray(jtv.stream(jnp.asarray(x), jnp.asarray(bh)))) < BF16_JAX_TOL
    tv2 = M.TVConvolver(cfg, nch, device="cpu")
    assert _rel(tv2.stream_chunked(x, bh, K=4).numpy(), y) < 1e-5


@pytest.mark.parametrize("tv", [False, True])
def test_bf16_decomposed_matches_jax(tv):
    pts, nparts = 32, 8
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts, ring_dtype="bf16")
    jcfg = J.PconvConfig.for_ir_length(pts * nparts, pts, ring_dtype="bf16")
    ir = RNG.standard_normal(cfg.cvs).astype(np.float32)
    bx = RNG.standard_normal((19, pts)).astype(np.float32)
    bh = RNG.standard_normal((19, pts)).astype(np.float32) if tv else None
    st = P.push_ir(cfg, P.pconv_init(cfg, "cpu"), torch.from_numpy(ir))
    args = (torch.from_numpy(bx),) + ((torch.from_numpy(bh),) if tv else ())
    st_d, out_d = DC.stream_decomposed(cfg, st, *args)
    st_s, out_s = (P.pconv_stream_tv if tv else P.pconv_stream)(cfg, st, *args)
    assert _rel(out_d.numpy(), out_s.numpy()) < 1e-5
    assert st_d.spec_x_re.dtype == torch.bfloat16 and st_d.spec_h_re.dtype == torch.bfloat16
    for name in ("spec_x_re", "spec_h_re"):
        assert torch.equal(getattr(st_d, name), getattr(st_s, name)), name
    jst = J.push_ir(jcfg, J.pconv_init(jcfg), jnp.asarray(ir))
    _, jout = JDC.stream_decomposed(jcfg, jst, jnp.asarray(bx),
                                    None if bh is None else jnp.asarray(bh))
    assert _rel(out_d.numpy(), np.asarray(jout)) < BF16_JAX_TOL


def test_bf16_state_crosses_from_jax():
    """A JAX bf16 stream read with np.asarray(x, np.float32) continues in
    the port (rings rounded back to bf16 exactly) within the bf16 bound of
    the JAX continuation, and the port's state goes back to JAX."""
    pts, nparts = 32, 8
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts, ring_dtype="bf16")
    jcfg = J.PconvConfig.for_ir_length(pts * nparts, pts, ring_dtype="bf16")
    ir = RNG.standard_normal(cfg.cvs).astype(np.float32)
    x = RNG.standard_normal((20, pts)).astype(np.float32)
    jst, _ = J.pconv_stream(jcfg, J.push_ir(jcfg, J.pconv_init(jcfg), jnp.asarray(ir)),
                            jnp.asarray(x[:9]))
    mid = _np(jst)
    st = pconv_state_from_numpy(mid, "cpu", cfg)
    assert st.spec_x_re.dtype == torch.bfloat16 and st.tail.dtype == torch.float32
    for name in ("spec_x_re", "spec_h_im"):
        assert np.array_equal(getattr(st, name).float().numpy(), mid[name])
    jst2, jout = J.pconv_stream(jcfg, jst, jnp.asarray(x[9:]))
    st, out = P.pconv_stream(cfg, st, torch.from_numpy(x[9:]))
    assert _rel(out.numpy(), np.asarray(jout)) < BF16_JAX_TOL
    back = pconv_state_to_numpy(st)
    assert back["spec_x_re"].dtype == np.float32
    jback = J.PconvState(**{k: (jnp.asarray(v).astype(jnp.bfloat16) if k.startswith("spec")
                                else jnp.asarray(v)) for k, v in back.items()})
    _, jo = J.pconv_stream(jcfg, jback, jnp.asarray(x[:4]))
    _, po = P.pconv_stream(cfg, st, torch.from_numpy(x[:4]))
    assert _rel(np.asarray(jo), po.numpy()) < BF16_JAX_TOL


@pytest.mark.parametrize("ring,dtype", [("bf16", "f32"), ("f32", "f64")])
def test_interop_roundtrips_keep_dtypes(ring, dtype):
    """pconv, crossfade and batched states of bf16 rings and float64 go to
    numpy (bf16 as float32) and back bit for bit, in their dtypes."""
    pts, nparts = 16, 4
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts, ring_dtype=ring, dtype=dtype)
    conv = M.Convolver(cfg, 2, device="cpu")
    conv.push_ir(RNG.standard_normal((2, cfg.cvs)))
    conv.stream(RNG.standard_normal((5, 2, pts)))
    conv.set_ir(RNG.standard_normal((1, cfg.cvs)), channels=[1], fade_blocks=3)
    conv.step(RNG.standard_normal((2, pts)))
    npdt = np.float64 if dtype == "f64" else np.float32
    for state, to_np, from_np in ((conv.state, pconv_state_to_numpy, pconv_state_from_numpy),
                                  (conv._xf, xfade_state_to_numpy, xfade_state_from_numpy)):
        fields = to_np(state)
        again = from_np(fields, "cpu", cfg)
        planes = fields["state"] if "state" in fields else fields
        assert planes["spec_x_re"].dtype == npdt and planes["tail"].dtype == npdt
        flat = lambda s: (s.state, s.old_h_re, s.old_h_im, s.old_tail) \
            if hasattr(s, "old_tail") else (s,)  # noqa: E731
        for a, b in zip(flat(state), flat(again)):
            if isinstance(a, P.PconvState):
                for name in P._PLANES:
                    assert getattr(a, name).dtype == getattr(b, name).dtype
                    assert torch.equal(getattr(a, name), getattr(b, name)), name
                assert (a.wp, a.wp2) == (b.wp, b.wp2)
            else:
                assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{"ring_dtype": "bf16"}, {"dtype": "f64"}])
def test_cuda_dtype_routes_take_no_kernel(cuda_device, kw):
    """Every pconv/dconv entry point with bf16 rings and with float64 runs on
    the card, agrees with the same call on the CPU, and launches none of the
    scan, step or sliding-MAC kernels."""
    from opencl_fft_tpu_torch.ops.cuda import blockstep as BS
    from opencl_fft_tpu_torch.ops.cuda import dstream as K
    from opencl_fft_tpu_torch.ops.cuda import mac as MC
    from opencl_fft_tpu_torch.ops.cuda import slidemac as SM
    from opencl_fft_tpu_torch.ops.cuda import splitstep as SP
    from opencl_fft_tpu_torch.ops.cuda import streamstep as S

    def counts():
        return (S.LAUNCHES, S.TV_LAUNCHES, S.BATCHED_LAUNCHES, S.BATCHED_TV_LAUNCHES,
                SP.LAUNCHES, SP.TV_LAUNCHES, MC.LAUNCHES, BS.STEP_LAUNCHES, BS.FWD_LAUNCHES,
                BS.FWD_TV_LAUNCHES, BS.MAC_UNPACK_LAUNCHES, SM.CHUNKMAC_LAUNCHES,
                SM.MACFLOW_LAUNCHES, SM.MACFLOW_BATCHED_LAUNCHES, SM.MACFLOW_TV_LAUNCHES,
                SM.MACFLOW_TV_BATCHED_LAUNCHES, K.LAUNCHES)

    rng = np.random.default_rng(3)
    tol = 5e-3 if "ring_dtype" in kw else 1e-12
    for pts in (64, 4096):
        cfg = P.PconvConfig.for_ir_length(4 * pts, pts, **kw)
        ir = torch.from_numpy(rng.standard_normal(cfg.cvs).astype(np.float32))
        bx = torch.from_numpy(rng.standard_normal((8, 2, pts)).astype(np.float32))
        before = counts()
        results = {}
        for dev in ("cpu", cuda_device):
            st = P.push_ir(cfg, P.pconv_init(cfg, dev), ir.to(dev))
            b = bx[:, 0].to(dev)
            bst = M.batched_state(cfg, 2, dev)
            bst = P.push_ir(cfg, bst, ir.to(dev).expand(2, -1))
            xf = P.pconv_begin_xfade(cfg, st, 0.5 * ir.to(dev))
            ramp = P._xfade_ramp(cfg, 0, 2, dev)
            results[str(dev)] = [
                P.pconv_step(cfg, st, b[0])[1], P.pconv_step_tv(cfg, st, b[0], b[1])[1],
                P.pconv_stream(cfg, st, b)[1], P.pconv_stream_tv(cfg, st, b, b.flip(0))[1],
                P.pconv_chunk(cfg, st, b[:3])[1], P.pconv_chunk_tv(cfg, st, b[:3], b[3:6])[1],
                P.pconv_offline(cfg, st, b)[1], DC.stream_decomposed(cfg, st, b)[1],
                DC.stream_decomposed(cfg, st, b, b.flip(0))[1],
                P.pconv_step_xfade(cfg, xf, b[0], ramp)[1],
                P.pconv_stream_batched(cfg, bst, bx.to(dev))[1],
                P.pconv_stream_batched_tv(cfg, bst, bx.to(dev), bx.to(dev).flip(0))[1],
                P.pconv_stream_batched_chunked(cfg, bst, bx.to(dev), K=4)[1],
                P.pconv_stream_batched_tv_chunked(cfg, bst, bx.to(dev), bx.to(dev), K=4)[1],
                P._offline_batched(cfg, bst, bx.to(dev))[1]]
        assert counts() == before
        for g, c in zip(results[str(cuda_device)], results["cpu"]):
            assert _rel(g.cpu().double().numpy(), c.double().numpy()) < tol
    if "dtype" in kw:
        dcfg = D.DconvConfig(irsize=512, vsize=512, dtype="f64")
        x = torch.from_numpy(rng.standard_normal((6, 512)))
        h = torch.from_numpy(rng.standard_normal(512))
        before = counts()
        outs = [D.dconv_stream(dcfg, D.push_ir(dcfg, D.dconv_init(dcfg, dev), h.to(dev)),
                               x.to(dev))[1].cpu() for dev in ("cpu", cuda_device)]
        assert counts() == before
        assert _rel(outs[1].numpy(), outs[0].numpy()) < tol


@pytest.mark.parametrize("kw", [{"ring_dtype": "bf16"}, {"dtype": "f64"}])
def test_per_channel_pointers_step_each_channel(kw):
    """A batched state with per-channel ring pointers streams, on the plain
    route, each channel as that channel alone (the JAX package vmaps the
    step over the pointers), LTI and TV."""
    pts, nparts, nch = 16, 4, 3
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts, **kw)
    conv = M.Convolver(cfg, nch, device="cpu")
    conv.push_ir(RNG.standard_normal((nch, cfg.cvs)))
    conv.stream(RNG.standard_normal((2, nch, pts)))
    st = conv.state._replace(wp=(1, 3, 0), wp2=(2, 0, 3))
    bx = torch.from_numpy(RNG.standard_normal((6, nch, pts))).to(cfg.compute_dtype)
    bh = torch.from_numpy(RNG.standard_normal((6, nch, pts))).to(cfg.compute_dtype)
    for tv in (False, True):
        got_st, got = (P.pconv_stream_batched_tv(cfg, st, bx, bh) if tv
                       else P.pconv_stream_batched(cfg, st, bx))
        for c in range(nch):
            one = P._channel(st, c)
            want_st, want = (P.pconv_stream_tv(cfg, one, bx[:, c], bh[:, c]) if tv
                             else P.pconv_stream(cfg, one, bx[:, c]))
            assert torch.equal(got[:, c], want)
            assert (got_st.wp[c], got_st.wp2[c]) == (want_st.wp, want_st.wp2)
            for name in P._PLANES:
                assert torch.equal(getattr(got_st, name)[c], getattr(want_st, name)), name


@pytest.mark.parametrize("kw", [{"ring_dtype": "bf16"}, {"dtype": "f64"}])
@pytest.mark.parametrize("tv", [False, True])
@pytest.mark.parametrize("nch", [None, 3])
@pytest.mark.parametrize("window", [None, 1])
def test_plain_stream_bitwise_equals_steps(kw, tv, nch, window, monkeypatch):
    """The streams of a config the kernels do not take run pconv_chunk{,_tv}
    in chunks of up to nparts blocks (window None: 2 chunks of 8 and one of
    3) or, under a small window budget, of one block (window 1): outputs
    and state bit-equal to sequential steps, one channel and batched."""
    if window is not None:
        monkeypatch.setattr(P, "_CHUNK_WINDOW_ELEMENTS", window)
    pts, nparts = 16, 8
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts, **kw)
    lead = () if nch is None else (nch,)
    ir = torch.from_numpy(RNG.standard_normal(lead + (cfg.cvs,))).to(cfg.compute_dtype)
    bx, bh = (torch.from_numpy(RNG.standard_normal((19,) + lead + (pts,))).to(cfg.compute_dtype)
              for _ in range(2))
    st0 = M.batched_state(cfg, nch, "cpu") if nch else P.pconv_init(cfg, "cpu")
    st0 = P.push_ir(cfg, st0, ir)
    st, seq = st0, []
    for i in range(19):
        st, o = P.pconv_step_tv(cfg, st, bx[i], bh[i]) if tv else P.pconv_step(cfg, st, bx[i])
        seq.append(o)
    stream = {(False, False): P.pconv_stream, (True, False): P.pconv_stream_tv,
              (False, True): P.pconv_stream_batched,
              (True, True): P.pconv_stream_batched_tv}[(tv, nch is not None)]
    got_st, got = stream(cfg, st0, bx, bh) if tv else stream(cfg, st0, bx)
    assert torch.equal(got, torch.stack(seq))
    assert (got_st.wp, got_st.wp2) == (st.wp, st.wp2)
    for name in P._PLANES:
        assert getattr(got_st, name).dtype == getattr(st, name).dtype, name
        assert torch.equal(getattr(got_st, name), getattr(st, name)), name
