"""Port parity: the whole-scan kernels of opencl_fft_tpu_torch
(``ops/cuda/streamstep.py``: ``stream_steps_fused{,_batched}{,_tv}`` and
their twins) as the counterparts of the JAX package's split scans, and the
streams above pts 2048, against opencl_fft_tpu on the same numpy-seeded
inputs.

The port's coefficient stacks (``ops/cuda/tables.py``) are bit-identical to
the JAX package's (``ops/pallas/splitstep.py``). The twins' FFT chains are
held against JAX's factored-table chains ``fwd_ref`` / ``inv_ref`` (with the
overlap-add) at pts 2..4096 (2e-5 relative) and against the dense-table
chains. The twins are held against the
JAX Pallas kernels ``stream_steps_fused_split{,_tv}`` in interpret mode
(pts 128, nparts 8, nb 16/24; outputs and tails atol 2e-5 * max|ref|, the
JAX stream-vs-scan tolerance; windows and rings 1e-5 * max|ring|), and
against the dense-table twins of ``ops/cuda/streamstep.py`` on the same
scan. At pts 4096, ``pconv_stream{,_tv}``, ``pconv_stream_batched{,_tv}``
and ``convolve`` are held against the JAX functions (2e-5, states crossing
packages) and float64 scipy (3e-5). The CUDA kernels are held against the
twins on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal as sps

from opencl_fft_tpu.ops import pconv as J
from opencl_fft_tpu.ops.pallas import splitstep as JS
from opencl_fft_tpu_torch import models as M
from opencl_fft_tpu_torch.interop import pconv_state_from_numpy, pconv_state_to_numpy
from opencl_fft_tpu_torch.ops import pconv as P
from opencl_fft_tpu_torch.ops.cuda import streamstep as S
from opencl_fft_tpu_torch.ops.cuda import tables as T
from opencl_fft_tpu_torch.ops.cuda import vmemfft as V

torch.set_num_threads(1)

CPU = "cpu"
RINGS = ("spec_x_re", "spec_x_im", "spec_h_re", "spec_h_im")


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, ref, rel):
    ref, got = _np(ref), _np(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=rel * (np.abs(ref).max() + 1e-30), rtol=0)


def _t(a, device=CPU):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _to_jax(state):
    return J.PconvState(**{k: jnp.asarray(v) for k, v in pconv_state_to_numpy(state).items()})


def _to_port(jstate):
    return pconv_state_from_numpy(J.PconvState(*map(np.asarray, jstate)), CPU)


def _assert_state_close(got, ref):
    for name in RINGS:
        _close(getattr(got, name), getattr(ref, name), 1e-5)
    _close(got.tail, ref.tail, 2e-5)
    for name in ("wp", "wp2"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(ref, name)), err_msg=name)


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [2, 4, 16, 128, 1024])
def test_split_tables_bit_identical_to_jax(m):
    """The coefficient stacks, built in O(m), against the JAX package's,
    from its dense pack matrix."""
    for mine, theirs in zip(T._coef_stacks_np(m), JS._coef_stacks_np(m)):
        np.testing.assert_array_equal(mine, theirs)
    for forward in (True, False):
        for mine, theirs in zip(T.pack_coeffs_np(m, forward), JS.pack_coeffs_np(m, forward)):
            for a, b in zip(mine, theirs):
                np.testing.assert_array_equal(a, b)
    fc, ic = T.coef_tables(m, torch.device(CPU))
    assert fc.is_contiguous() and ic.is_contiguous() and fc.shape == ic.shape == (8, m)
    np.testing.assert_array_equal(fc.numpy(), T._coef_stacks_np(m)[0])
    np.testing.assert_array_equal(ic.numpy(), T._coef_stacks_np(m)[1])


@pytest.mark.parametrize("m", [2, 4, 16, 128])
@pytest.mark.parametrize("forward", [True, False])
def test_pack_coeffs_rebuild_the_pack_matrix(m, forward):
    """Each block of the (2m, 2m) pack matrix is diag(x1) + nflip @ diag(x2)
    of its pair of vectors, exactly."""
    u = T._pack_matrix_np(m, forward)
    k = np.arange(m)
    for (x1, x2), blk in zip(T.pack_coeffs_np(m, forward),
                             (u[:m, :m], u[m:, :m], u[:m, m:], u[m:, m:])):
        rec = np.diag(x1)
        rec[(m - k) % m, k] += x2
        np.testing.assert_array_equal(rec, blk)


@pytest.mark.parametrize("pts", [16, 128])
def test_factored_chains_match_the_dense_tables(pts):
    """The twin's two transform steps (FFTs and coefficient stacks) against
    the dense-table ones."""
    rng = np.random.default_rng(pts)
    blocks = _t(rng.standard_normal((5, 2, pts)).astype(np.float32))
    for s, d in zip(S._fft_frames(blocks, pts), S._dense_frames(blocks, pts)):
        _close(s, d, 1e-5)
    acc = [_t(rng.standard_normal((2, 5, pts)).astype(np.float32)) for _ in range(2)]
    tails = _t(rng.standard_normal((2, pts)).astype(np.float32))
    for s, d in zip(S._fft_post_ola(*acc, tails, pts), S._post_ola_plain(*acc, tails, pts)):
        _close(s, d, 1e-5)


@pytest.mark.parametrize("pts", [2, 16, 4096, 1 << 14, 1 << 15, 1 << 20, 1 << 24, 1 << 26])
def test_kernel_plan_covers_every_size(pts):
    """What the kernels are handed: one transform in a CTA up to 2^14 (the
    pass tables of pts), the four-step above with both factors in
    [2, 2^13] and its tables; above 2^26 the wrapper raises."""
    plan = S._plan(pts, torch.device(CPU))
    assert len(plan.tables) == len(plan.tabs) == 10
    for sign, tabs in ((-1, plan.tables[:5]), (1, plan.tables[5:])):
        if pts <= 1 << 14:
            assert plan.log_n1 == 0 and tabs[0] is None and tabs[2:] == (None,) * 3
            np.testing.assert_array_equal(tabs[1].numpy(), V.pass_twiddle_np(pts, sign))
            continue
        n1 = 1 << plan.log_n1
        n2 = pts // n1
        assert n1 * n2 == pts and 2 <= min(n1, n2) and max(n1, n2) <= 1 << 13
        assert plan.log_a == V.four_step_log_a(n2)
        np.testing.assert_array_equal(tabs[0].numpy(), V.pass_twiddle_np(n1, sign))
        np.testing.assert_array_equal(tabs[1].numpy(), V.pass_twiddle_np(n2, sign))
        for got, want in zip(tabs[2:], V.four_step_tables_np(n1, n2, sign)):
            np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="pts <= "):
        S._kernel_args(2 * S.MAX_PTS, 1, 1, torch.device(CPU))


CHAIN_PTS = [2, 4, 16, 128, 1024, 4096]


@pytest.mark.parametrize("pts", CHAIN_PTS)
def test_fft_frames_match_jax_fwd_ref(pts):
    """The forward chain (FFT of z, pack) against JAX's factored-table
    chain."""
    rng = np.random.default_rng(pts + 1)
    blocks = rng.standard_normal((4, 3, pts)).astype(np.float32)
    got = S._fft_frames(_t(blocks), pts)
    ref = JS.fwd_ref(jnp.asarray(blocks), pts)
    for g, r in zip(got, ref):
        _close(g, np.asarray(r).transpose(1, 0, 2), 2e-5)


@pytest.mark.parametrize("pts", CHAIN_PTS)
def test_fft_post_ola_matches_jax_inv_ref(pts):
    """The inverse chain with the overlap-add folded in against JAX's
    factored-table chain and its OLA: (out1[t] + out2[t-1]) / pts, the
    carried tail before row 0, out2 of the last row the final tail."""
    rng = np.random.default_rng(pts + 2)
    acc = [rng.standard_normal((3, 5, pts)).astype(np.float32) for _ in range(2)]
    tails = rng.standard_normal((3, pts)).astype(np.float32)
    outs, tailf = S._fft_post_ola(_t(acc[0]), _t(acc[1]), _t(tails), pts)
    out1, out2 = (np.asarray(o) for o in JS.inv_ref(jnp.asarray(acc[0]), jnp.asarray(acc[1]),
                                                    pts))
    prev = np.concatenate([tails[:, None], out2[:, :-1]], 1)
    _close(outs, ((out1 + prev) / pts).transpose(1, 0, 2), 2e-5)
    _close(tailf, out2[:, -1], 2e-5)


# ---------------------------------------------------------------------------
# the twins against the Pallas kernels and the dense twins
# ---------------------------------------------------------------------------

def _scan_inputs(seed, pts, nparts, nb, nch=None):
    rng = np.random.default_rng(seed)
    lead = () if nch is None else (nch,)

    def f(*shape, s=1.0):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    blk = (nb,) + lead + (pts,)
    return dict(bx=f(*blk, s=0.1), bh=f(*blk, s=0.1), w0=(f(*lead, nparts, pts),
                f(*lead, nparts, pts)), h=(f(*lead, nparts, pts, s=0.05),
                f(*lead, nparts, pts, s=0.05)), tail=f(*lead, pts))


def _pair(planes, fn=_t):
    return tuple(fn(p) for p in planes)


def _dense_oracle(bx, w0, h, b0, tail, pts):
    """The single-channel LTI scan around the JAX kernels' dense-table
    chains (``_dense_frames``, ``_post_ola_plain``)."""
    outs, (wr, wi), tailf = S._lti_scan_plain(bx[:, None], S._one(w0), S._one(h), b0,
                                              tail[None], pts, S._dense_frames,
                                              S._post_ola_plain)
    return outs[:, 0], (wr[0], wi[0]), tailf[0]


def _dense_tv_oracle(bx, bh, w0, h0, wp2, b0, tail, pts):
    """The single-channel TV scan around the dense-table chains."""
    outs, (wr, wi), (hr, hi), tailf = S._tv_scan_plain(
        bx[:, None], bh[:, None], S._one(w0), S._one(h0), wp2, b0, tail[None], pts,
        S._dense_frames, S._post_ola_plain)
    return outs[:, 0], (wr[0], wi[0]), (hr[0], hi[0]), tailf[0]


@pytest.mark.parametrize("nb", [16, 24])
@pytest.mark.parametrize("b0", [2.0, 1.0])
def test_split_twin_matches_pallas_kernel_and_dense_twin(nb, b0):
    pts, nparts = 128, 8
    d = _scan_inputs(nb, pts, nparts, nb)
    jo, jw, jt = JS.stream_steps_fused_split(jnp.asarray(d["bx"]), _pair(d["w0"], jnp.asarray),
                                             _pair(d["h"], jnp.asarray), b0,
                                             jnp.asarray(d["tail"]), pts, interpret=True)
    args = (_t(d["bx"]), _pair(d["w0"]), _pair(d["h"]), b0, _t(d["tail"]), pts)
    before = S.BATCHED_LAUNCHES
    got = S.stream_steps_fused(*args)
    assert S.BATCHED_LAUNCHES == before                   # the CPU runs the twin
    dense = _dense_oracle(*args)
    for ref in ((jo, jw, jt), dense):
        _close(got[0], ref[0], 2e-5)
        _close(got[2], ref[2], 2e-5)
        for g, r in zip(got[1], ref[1]):
            _close(g, r, 1e-5)


@pytest.mark.parametrize("nb,wp2", [(16, 7), (24, 3), (16, 0)])
@pytest.mark.parametrize("b0", [2.0, 1.0])
def test_split_tv_twin_matches_pallas_kernel_and_dense_twin(nb, wp2, b0):
    pts, nparts = 128, 8
    d = _scan_inputs(100 + nb + wp2, pts, nparts, nb)
    blocks2 = np.stack([d["bx"], d["bh"]], 1).reshape(2 * nb, pts)
    jo, jw, jh, jt = JS.stream_steps_fused_split_tv(
        jnp.asarray(blocks2), _pair(d["w0"], jnp.asarray), _pair(d["h"], jnp.asarray), wp2, b0,
        jnp.asarray(d["tail"]), pts, interpret=True)
    args = (_t(d["bx"]), _t(d["bh"]), _pair(d["w0"]), _pair(d["h"]), wp2, b0, _t(d["tail"]),
            pts)
    got = S.stream_steps_fused_tv(*args)
    dense = _dense_tv_oracle(*args)
    for ref in ((jo, jw, jh, jt), dense):
        _close(got[0], ref[0], 2e-5)
        _close(got[3], ref[3], 2e-5)
        for g, r in zip((*got[1], *got[2]), (*ref[1], *ref[2])):
            _close(g, r, 1e-5)


@pytest.mark.parametrize("tv", [False, True])
def test_split_batched_twin_channels_match_single_channel(tv):
    pts, nparts, nb, nch = 32, 3, 7, 3
    d = _scan_inputs(7, pts, nparts, nb, nch)
    wp2 = (2, 0, 1)
    if tv:
        got = S.stream_steps_fused_batched_tv(_t(d["bx"]), _t(d["bh"]), _pair(d["w0"]),
                                              _pair(d["h"]), wp2, 2.0, _t(d["tail"]), pts)
    else:
        got = S.stream_steps_fused_batched(_t(d["bx"]), _pair(d["w0"]), _pair(d["h"]), 2.0,
                                           _t(d["tail"]), pts)
    for c in range(nch):
        one = lambda planes: tuple(_t(p[c]) for p in planes)  # noqa: E731
        if tv:
            ref = S.stream_steps_fused_tv(_t(d["bx"][:, c]), _t(d["bh"][:, c]), one(d["w0"]),
                                          one(d["h"]), wp2[c], 2.0, _t(d["tail"][c]), pts)
            pairs = [(got[0][:, c], ref[0]), (got[3][c], ref[3])] + [
                (g[c], r) for g, r in zip((*got[1], *got[2]), (*ref[1], *ref[2]))]
        else:
            ref = S.stream_steps_fused(_t(d["bx"][:, c]), one(d["w0"]), one(d["h"]), 2.0,
                                       _t(d["tail"][c]), pts)
            pairs = [(got[0][:, c], ref[0]), (got[2][c], ref[2])] + [
                (g[c], r) for g, r in zip(got[1], ref[1])]
        for g, r in pairs:
            np.testing.assert_array_equal(g.numpy(), r.numpy())


def test_split_wrappers_validate():
    z = torch.zeros
    w = (z(2, 16), z(2, 16))
    with pytest.raises(ValueError, match="power-of-two pts"):
        S.stream_steps_fused(z(3, 12), (z(2, 12), z(2, 12)), (z(2, 12), z(2, 12)), 2.0, z(12),
                             12)
    with pytest.raises(ValueError, match="blocks must be"):
        S.stream_steps_fused(z(3, 8), w, w, 2.0, z(16), 16)
    with pytest.raises(ValueError, match="blocks_h must have the shape"):
        S.stream_steps_fused_tv(z(3, 16), z(2, 16), w, w, 0, 2.0, z(16), 16)
    with pytest.raises(ValueError, match="one pointer per channel"):
        S.stream_steps_fused_batched_tv(z(3, 2, 16), z(3, 2, 16), (z(2, 2, 16),) * 2,
                                        (z(2, 2, 16),) * 2, (0, 1, 1), 2.0, z(2, 16), 16)


# ---------------------------------------------------------------------------
# the streams at pts 4096
# ---------------------------------------------------------------------------

PTS, NPARTS, NB = 4096, 2, 3


def _long_ir_state(seed, nch=None):
    cfg = P.PconvConfig(pts=PTS, nparts=NPARTS)
    rng = np.random.default_rng(seed)
    shape = (cfg.cvs,) if nch is None else (nch, cfg.cvs)
    irs = (rng.standard_normal(shape) * np.exp(-np.arange(cfg.cvs) / 2000.0)).astype(np.float32)
    st = M.batched_state(cfg, nch, CPU) if nch else P.pconv_init(cfg, CPU)
    return cfg, J.PconvConfig(pts=PTS, nparts=NPARTS), P.push_ir(cfg, st, _t(irs)), irs, rng


def test_pconv_stream_above_2048_runs_the_split_scan_and_matches_jax_and_scipy():
    cfg, jcfg, st, ir, rng = _long_ir_state(1)
    x = rng.standard_normal((2 * NB, PTS)).astype(np.float32)
    s1, y1 = P.pconv_stream(cfg, st, _t(x[:NB]))
    js1, jy1 = J.pconv_stream(jcfg, _to_jax(st), jnp.asarray(x[:NB]))
    _close(y1, jy1, 2e-5)
    _assert_state_close(s1, js1)
    s2, y2 = P.pconv_stream(cfg, _to_port(js1), _t(x[NB:]))   # JAX -> port mid-stream
    _, jy2 = J.pconv_stream(jcfg, js1, jnp.asarray(x[NB:]))
    _close(y2, jy2, 2e-5)
    ref = sps.fftconvolve(x.reshape(-1).astype(np.float64), ir.astype(np.float64))
    _close(torch.cat([y1, y2]).reshape(-1), ref[:2 * NB * PTS], 3e-5)
    twin = S.stream_steps_fused_plain(
        _t(x[:NB]), (st.spec_x_re[:NPARTS], st.spec_x_im[:NPARTS]),
        (st.spec_h_re, st.spec_h_im), cfg.b0_scale, st.tail, PTS)[0]
    np.testing.assert_array_equal(y1.numpy(), twin.numpy())


def test_pconv_stream_tv_above_2048_matches_jax_and_scipy():
    """The IR fed cyclically through the second operand reproduces the
    pushed IR's convolution; the state crosses packages mid-stream."""
    cfg, jcfg, st, ir, rng = _long_ir_state(2)
    x = rng.standard_normal((2 * NB, PTS)).astype(np.float32)
    hcyc = ir.reshape(NPARTS, PTS)[np.arange(2 * NB) % NPARTS]
    s1, y1 = P.pconv_stream_tv(cfg, st, _t(x[:NB]), _t(hcyc[:NB]))
    js1, jy1 = J.pconv_stream_tv(jcfg, _to_jax(st), jnp.asarray(x[:NB]),
                                 jnp.asarray(hcyc[:NB]))
    _close(y1, jy1, 2e-5)
    _assert_state_close(s1, js1)
    _, y2 = P.pconv_stream_tv(cfg, _to_port(js1), _t(x[NB:]), _t(hcyc[NB:]))
    ref = sps.fftconvolve(x.reshape(-1).astype(np.float64), ir.astype(np.float64))
    _close(torch.cat([y1, y2]).reshape(-1), ref[:2 * NB * PTS], 3e-5)


@pytest.mark.parametrize("tv", [False, True])
@pytest.mark.parametrize("per_channel", [False, True])
def test_batched_streams_above_2048_match_jax(tv, per_channel):
    cfg, jcfg, st, irs, rng = _long_ir_state(3 + tv + 2 * per_channel, nch=2)
    if per_channel:      # two channels at different ring pointers
        st = st._replace(wp=(0, 1), wp2=(1, 0))
    bx = rng.standard_normal((NB, 2, PTS)).astype(np.float32)
    bh = (0.3 * rng.standard_normal((NB, 2, PTS))).astype(np.float32)
    js = _to_jax(st)
    if tv:
        got_s, got = P.pconv_stream_batched_tv(cfg, st, _t(bx), _t(bh))
        ref_s, ref = J.pconv_stream_batched_tv(jcfg, js, jnp.asarray(bx), jnp.asarray(bh))
    else:
        got_s, got = P.pconv_stream_batched(cfg, st, _t(bx))
        ref_s, ref = J.pconv_stream_batched(jcfg, js, jnp.asarray(bx))
    _close(got, ref, 2e-5)
    for name in RINGS + ("tail",):
        _close(getattr(got_s, name), getattr(ref_s, name), 2e-5)
    for name in ("wp", "wp2"):
        np.testing.assert_array_equal(np.asarray(getattr(got_s, name)),
                                      np.asarray(getattr(ref_s, name)), err_msg=name)
    if not (tv or per_channel):
        for c in range(2):
            ref_c = sps.fftconvolve(bx[:, c].reshape(-1).astype(np.float64),
                                    irs[c].astype(np.float64))[:NB * PTS]
            _close(got[:, c].reshape(-1), ref_c, 3e-5)


def test_convolve_above_2048_matches_jax_and_scipy():
    rng = np.random.default_rng(9)
    x = rng.standard_normal(3 * PTS + 100).astype(np.float32)
    ir = rng.standard_normal(PTS + 7).astype(np.float32)
    got = P.convolve(_t(x), _t(ir), PTS)
    ref = sps.fftconvolve(x.astype(np.float64), ir.astype(np.float64))
    _close(got, ref, 3e-5)
    _close(got, J.convolve(jnp.asarray(x), jnp.asarray(ir), PTS), 2e-5)


def test_models_stream_above_2048_match_single_channel_scans():
    cfg = P.PconvConfig(pts=PTS, nparts=NPARTS)
    rng = np.random.default_rng(10)
    irs = (0.3 * rng.standard_normal((2, cfg.cvs))).astype(np.float32)
    bx = rng.standard_normal((NB, 2, PTS)).astype(np.float32)
    conv = M.Convolver(cfg, 2, device=CPU)
    conv.push_ir(irs)
    tvc = M.TVConvolver(cfg, 2, device=CPU)
    hcyc = irs.reshape(2, NPARTS, PTS)[:, np.arange(NB) % NPARTS].transpose(1, 0, 2)
    y, y_tv = conv.stream(bx), tvc.stream(bx, np.ascontiguousarray(hcyc))
    for c in range(2):
        st = P.push_ir(cfg, P.pconv_init(cfg, CPU), _t(irs[c]))
        ref = P.pconv_stream(cfg, st, _t(bx[:, c]))[1]
        _close(y[:, c], ref, 2e-5)
        _close(y_tv[:, c], ref, 2e-5)
    m = M.MatrixConvolver(cfg, 1, 2, device=CPU)       # one input, two outputs
    m.push_ir(irs[:, None])
    conv0 = M.Convolver(cfg, 2, device=CPU)
    conv0.push_ir(irs)
    _close(m.stream(bx[:, :1]), conv0.stream(np.repeat(bx[:, :1], 2, 1)), 1e-6)


# ---------------------------------------------------------------------------
# the kernels on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the scan kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pts,nparts,nb,nch", [(16, 1, 1, 1), (64, 3, 5, 3), (512, 16, 21, 2),
                                               (4096, 4, 9, 2), (8192, 2, 3, 2),
                                               (16384, 2, 3, 1), (32768, 2, 2, 2)])
def test_cuda_split_kernels_match_twins(cuda_device, pts, nparts, nb, nch):
    d = _scan_inputs(pts + nb, pts, nparts, nb, nch)
    dev = lambda a: _t(a, cuda_device)  # noqa: E731
    args = (dev(d["bx"]), _pair(d["w0"], dev), _pair(d["h"], dev), 2.0, dev(d["tail"]), pts)
    n0 = S.BATCHED_LAUNCHES
    got = S.stream_steps_fused_batched(*args)
    torch.cuda.synchronize()
    assert S.BATCHED_LAUNCHES == n0 + 1
    want = S.stream_steps_fused_batched_plain(*args)
    for g, w in ((got[0], want[0]), (got[2], want[2]), *zip(got[1], want[1])):
        _close(g, w, 2e-5)
    wp2 = tuple((3 * c + 1) % nparts for c in range(nch))
    targs = (dev(d["bx"]), dev(d["bh"]), _pair(d["w0"], dev), _pair(d["h"], dev), wp2, 1.0,
             dev(d["tail"]), pts)
    n0 = S.BATCHED_TV_LAUNCHES
    got = S.stream_steps_fused_batched_tv(*targs)
    torch.cuda.synchronize()
    assert S.BATCHED_TV_LAUNCHES == n0 + 1
    want = S.stream_steps_fused_batched_tv_plain(*targs)
    for g, w in ((got[0], want[0]), (got[3], want[3]), *zip(got[1], want[1]),
                 *zip(got[2], want[2])):
        _close(g, w, 2e-5)
