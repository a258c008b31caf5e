"""Port parity: the batched (multi-channel) serving path of
opencl_fft_tpu_torch against opencl_fft_tpu on the same inputs.

The plain twins ``stream_steps_fused_batched{,_tv}_plain`` are held against
the JAX Pallas kernels ``stream_steps_fused_batched{,_tv}`` in interpret
mode (outputs and tails atol 2e-5 * max|ref|, the JAX package's
stream-vs-scan tolerance; final windows and h rings atol 1e-5 * max|ring|),
and each twin channel against the single-channel twin.
``pconv_stream_batched{,_tv}`` are held against the JAX
``pconv_stream_batched{,_tv}`` through its vmapped XLA scan
(pallas="off"), with shared and per-channel ring pointers, and the batched
per-block steps against the JAX vmapped steps, at the same tolerances. The
CUDA kernels are held against the twins on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_fft_tpu.models import convolver as JM
from opencl_fft_tpu.ops import pconv as J
from opencl_fft_tpu.ops.pallas.streamstep import \
    stream_steps_fused_batched as jax_batched
from opencl_fft_tpu.ops.pallas.streamstep import \
    stream_steps_fused_batched_tv as jax_batched_tv
from opencl_fft_tpu.ops.pallas.streamstep import \
    stream_steps_fused_tv as jax_tv
from opencl_fft_tpu_torch.interop import pconv_state_from_numpy
from opencl_fft_tpu_torch.models import batched_state
from opencl_fft_tpu_torch.ops import pconv as P
from opencl_fft_tpu_torch.ops.cuda import streamstep as S

torch.set_num_threads(1)

RINGS = ("spec_x_re", "spec_x_im", "spec_h_re", "spec_h_im")


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, ref, rel):
    ref = _np(ref)
    np.testing.assert_allclose(_np(got), ref, atol=rel * (np.abs(ref).max() + 1e-30),
                               rtol=0)


def _inputs(seed, pts, nparts, nb, nch):
    rng = np.random.default_rng(seed)

    def f(*shape, s=1.0):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    return dict(bx=f(nb, nch, pts), bh=f(nb, nch, pts, s=0.2), w0r=f(nch, nparts, pts),
                w0i=f(nch, nparts, pts), h0r=f(nch, nparts, pts, s=0.2),
                h0i=f(nch, nparts, pts, s=0.2), tails=f(nch, pts))


def _torch(d, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in d.items()}


def _run(d, b0, pts, fn=S.stream_steps_fused_batched_plain, device="cpu"):
    t = _torch(d, device)
    outs, (wr, wi), tails = fn(t["bx"], (t["w0r"], t["w0i"]), (t["h0r"], t["h0i"]), b0,
                               t["tails"], pts)
    return outs, wr, wi, tails


def _run_tv(d, wp2, b0, pts, fn=S.stream_steps_fused_batched_tv_plain, device="cpu"):
    t = _torch(d, device)
    outs, (wr, wi), (hr, hi), tails = fn(t["bx"], t["bh"], (t["w0r"], t["w0i"]),
                                         (t["h0r"], t["h0i"]), wp2, b0, t["tails"], pts)
    return outs, wr, wi, hr, hi, tails


def _assert_scan_close(got, ref):
    """(outs, *rings, tails): outputs and tails at 2e-5, rings at 1e-5."""
    _close(got[0], ref[0], 2e-5)
    _close(got[-1], ref[-1], 2e-5)
    for g, r in zip(got[1:-1], ref[1:-1]):
        _close(g, r, 1e-5)


def _stacked(a, nch):
    """(C * rows, bins) JAX planes -> (C, rows, bins)."""
    a = np.asarray(a)
    return a.reshape(nch, -1, a.shape[-1])


@pytest.mark.parametrize("pts", [64, 128])
@pytest.mark.parametrize("nparts", [4, 8])
@pytest.mark.parametrize("nch", [1, 3])
@pytest.mark.parametrize("b0", [1.0, 2.0])
def test_batched_twin_matches_pallas_kernel(pts, nparts, nch, b0):
    nb = 8
    d = _inputs(pts + nparts + nch, pts, nparts, nb, nch)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    outs, (wr, wi), tails = jax_batched(
        j["bx"].reshape(nb * nch, pts),
        (j["w0r"].reshape(-1, pts), j["w0i"].reshape(-1, pts)),
        (j["h0r"].reshape(-1, pts), j["h0i"].reshape(-1, pts)), b0, j["tails"], pts, nch,
        interpret=True)
    ref = (np.asarray(outs).reshape(nb, nch, pts), _stacked(wr, nch), _stacked(wi, nch),
           tails)
    _assert_scan_close(_run(d, b0, pts), ref)


@pytest.mark.parametrize("pts", [64, 128])
@pytest.mark.parametrize("nparts", [4, 8])
@pytest.mark.parametrize("nch", [1, 3])
@pytest.mark.parametrize("b0", [1.0, 2.0])
def test_batched_tv_twin_matches_pallas_kernel(pts, nparts, nch, b0):
    nb = 8
    wp2 = nparts - 1 if nch == 1 else 1
    d = _inputs(pts + nparts + 7 * nch, pts, nparts, nb, nch)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    blocks2 = jnp.stack([j["bx"], j["bh"]], axis=1).reshape(2 * nb * nch, pts)
    outs, (wr, wi), (hr, hi), tails = jax_batched_tv(
        blocks2, (j["w0r"].reshape(-1, pts), j["w0i"].reshape(-1, pts)),
        (j["h0r"].reshape(-1, pts), j["h0i"].reshape(-1, pts)), wp2, b0, j["tails"], pts,
        nch, interpret=True)
    ref = (np.asarray(outs).reshape(nb, nch, pts),
           *(_stacked(a, nch) for a in (wr, wi, hr, hi)), tails)
    _assert_scan_close(_run_tv(d, wp2, b0, pts), ref)


PTS_ALL = [2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048]
B0 = [pytest.param(1.0, id="compat"), pytest.param(2.0, id="exact")]


def _jax_batched(d, b0, pts, nch, wp2=None):
    """The JAX batched Pallas kernel (TV with a shared ``wp2``) in interpret
    mode, its results laid out as the twins' (outs, *planes, tails)."""
    nb = d["bx"].shape[0]
    j = {k: jnp.asarray(v) for k, v in d.items()}
    w0 = (j["w0r"].reshape(-1, pts), j["w0i"].reshape(-1, pts))
    h0 = (j["h0r"].reshape(-1, pts), j["h0i"].reshape(-1, pts))
    if wp2 is None:
        outs, (wr, wi), tails = jax_batched(j["bx"].reshape(nb * nch, pts), w0, h0, b0,
                                            j["tails"], pts, nch, interpret=True)
        planes = (wr, wi)
    else:
        blocks2 = jnp.stack([j["bx"], j["bh"]], axis=1).reshape(2 * nb * nch, pts)
        outs, (wr, wi), (hr, hi), tails = jax_batched_tv(blocks2, w0, h0, wp2, b0, j["tails"],
                                                         pts, nch, interpret=True)
        planes = (wr, wi, hr, hi)
    return (np.asarray(outs).reshape(nb, nch, pts), *(_stacked(a, nch) for a in planes),
            tails)


@pytest.mark.parametrize("pts", PTS_ALL)
@pytest.mark.parametrize("b0", B0)
def test_fft_batched_twins_match_pallas_kernels_at_every_pts(pts, b0):
    """The batched twins' chains are FFT-sized; the JAX kernels' dense DFT
    products: the same LTI and TV (shared pointer) scans within 2e-5."""
    nparts, nb, nch = 3, 8, 2
    d = _inputs(7 * pts + int(b0), pts, nparts, nb, nch)
    _assert_scan_close(_run(d, b0, pts), _jax_batched(d, b0, pts, nch))
    _assert_scan_close(_run_tv(d, 2, b0, pts), _jax_batched(d, b0, pts, nch, wp2=2))


@pytest.mark.parametrize("pts", PTS_ALL)
def test_fft_batched_tv_twin_per_channel_pointers_match_pallas_kernel(pts):
    """Per-channel ring pointers (the JAX batched kernel shares one): each
    channel of the batched TV twin against the JAX single-channel TV kernel
    at that channel's pointer."""
    nparts, nb, nch = 3, 8, 2
    d = _inputs(11 * pts, pts, nparts, nb, nch)
    wp2 = (2, 0)
    tv = _run_tv(d, wp2, 2.0, pts)
    for c in range(nch):
        j = {k: jnp.asarray(v[:, c] if k in ("bx", "bh") else v[c]) for k, v in d.items()}
        blocks2 = jnp.stack([j["bx"], j["bh"]], axis=1).reshape(2 * nb, pts)
        ref = jax_tv(blocks2, (j["w0r"], j["w0i"]), (j["h0r"], j["h0i"]), wp2[c], 2.0,
                     j["tails"], pts, interpret=True)
        _assert_scan_close((tv[0][:, c], *(a[c] for a in tv[1:])),
                           (ref[0], *ref[1], *ref[2], ref[3]))


@pytest.mark.parametrize("pts,nparts,nb,nch", [(16, 5, 13, 3), (16, 1, 3, 2),
                                               (32, 7, 9, 4), (16, 4, 2, 1)])
def test_twin_channels_match_single_channel_twins(pts, nparts, nb, nch):
    """Every channel of the batched twins equals the single-channel twin on
    that channel's inputs, at shapes the JAX kernels do not take (nb not a
    multiple of 8, nb < nparts, nparts = 1), with per-channel wp2."""
    d = _inputs(nb * nparts + nch, pts, nparts, nb, nch)
    t = _torch(d)
    wp2 = tuple((3 * c + 1) % nparts for c in range(nch))
    lti = _run(d, 2.0, pts)
    tv = _run_tv(d, wp2, 2.0, pts)
    for c in range(nch):
        w0, h0 = (t["w0r"][c], t["w0i"][c]), (t["h0r"][c], t["h0i"][c])
        outs, (wr, wi), tail = S.stream_steps_fused_plain(t["bx"][:, c], w0, h0, 2.0,
                                                          t["tails"][c], pts)
        _assert_scan_close((lti[0][:, c], lti[1][c], lti[2][c], lti[3][c]),
                           (outs, wr, wi, tail))
        outs, (wr, wi), (hr, hi), tail = S.stream_steps_fused_tv_plain(
            t["bx"][:, c], t["bh"][:, c], w0, h0, wp2[c], 2.0, t["tails"][c], pts)
        _assert_scan_close((tv[0][:, c], *(a[c] for a in tv[1:])),
                           (outs, wr, wi, hr, hi, tail))


def _configs(pts, nparts, bin0_mode="exact"):
    return (J.PconvConfig(pts=pts, nparts=nparts, bin0_mode=bin0_mode, pallas="off"),
            P.PconvConfig(pts=pts, nparts=nparts, bin0_mode=bin0_mode))


def _assert_state_close(got, ref):
    for name in RINGS:
        g, r = _np(getattr(got, name)), _np(getattr(ref, name))
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g, r, atol=1e-5 * (np.abs(r).max() + 1e-30),
                                   rtol=0, err_msg=name)
    _close(got.tail, ref.tail, 2e-5)
    for name in ("wp", "wp2"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(ref, name)), err_msg=name)


def _seeded(jcfg, tcfg, nch, rng):
    irs = (0.3 * rng.standard_normal((nch, tcfg.cvs))).astype(np.float32)
    js = JM._vmapped_push(jcfg)(JM.batched_state(jcfg, nch), jnp.asarray(irs))
    ts = P.push_ir(tcfg, batched_state(tcfg, nch, "cpu"), torch.from_numpy(irs))
    return js, ts


@pytest.mark.parametrize("bin0_mode", ["exact", "compat"])
@pytest.mark.parametrize("pts,nparts,nch", [(32, 4, 3), (16, 5, 2)])
def test_stream_batched_matches_jax_over_chained_calls(pts, nparts, nch, bin0_mode):
    """nb = 21 (not a multiple of 8), then a chained call from non-zero wp."""
    jcfg, tcfg = _configs(pts, nparts, bin0_mode)
    rng = np.random.default_rng(pts + nch)
    js, ts = _seeded(jcfg, tcfg, nch, rng)
    _assert_state_close(ts, js)
    blocks = rng.standard_normal((2, 21, nch, pts)).astype(np.float32)
    for call in range(2):
        js, jo = J.pconv_stream_batched(jcfg, js, jnp.asarray(blocks[call]))
        ts, to = P.pconv_stream_batched(tcfg, ts, torch.from_numpy(blocks[call]))
        assert to.shape == (21, nch, pts)
        _close(to, jo, 2e-5)
        _assert_state_close(ts, js)


@pytest.mark.parametrize("pts,nparts,nch", [(32, 4, 3), (16, 5, 2)])
def test_stream_batched_tv_matches_jax_over_chained_calls(pts, nparts, nch):
    jcfg, tcfg = _configs(pts, nparts)
    rng = np.random.default_rng(pts + nparts)
    js, ts = _seeded(jcfg, tcfg, nch, rng)
    bx = rng.standard_normal((2, 21, nch, pts)).astype(np.float32)
    bh = (0.3 * rng.standard_normal((2, 21, nch, pts))).astype(np.float32)
    for call in range(2):
        js, jo = J.pconv_stream_batched_tv(jcfg, js, jnp.asarray(bx[call]),
                                           jnp.asarray(bh[call]))
        ts, to = P.pconv_stream_batched_tv(tcfg, ts, torch.from_numpy(bx[call]),
                                           torch.from_numpy(bh[call]))
        _close(to, jo, 2e-5)
        _assert_state_close(ts, js)


def test_per_channel_pointers_in_lockstep_equal_shared():
    """Lockstep per-channel pointer tuples reproduce the shared-int result
    exactly (the JAX package's per-channel pointer case), and the state
    crosses from JAX with vector pointers as tuples."""
    cfg = P.PconvConfig(pts=32, nparts=4)
    rng = np.random.default_rng(11)
    nch = 3
    irs = torch.from_numpy(rng.standard_normal((nch, 128)).astype(np.float32))
    blocks = torch.from_numpy(rng.standard_normal((6, nch, 32)).astype(np.float32))
    st = P.push_ir(cfg, batched_state(cfg, nch, "cpu"), irs)
    st_vec = st._replace(wp=(st.wp,) * nch, wp2=(st.wp2,) * nch)
    sv, out_vec = P.pconv_stream_batched(cfg, st_vec, blocks)
    ss, out_shared = P.pconv_stream_batched(cfg, st, blocks)
    np.testing.assert_array_equal(out_vec.numpy(), out_shared.numpy())
    assert sv.wp == (ss.wp,) * nch
    sv, out_vec = P.pconv_stream_batched_tv(cfg, st_vec, blocks, blocks)
    ss, out_shared = P.pconv_stream_batched_tv(cfg, st, blocks, blocks)
    np.testing.assert_array_equal(out_vec.numpy(), out_shared.numpy())
    assert sv.wp2 == (ss.wp2,) * nch
    for name in RINGS + ("tail",):
        np.testing.assert_array_equal(getattr(sv, name).numpy(), getattr(ss, name).numpy())

    fields = {k: np.asarray(v) for k, v in JM.batched_state(
        J.PconvConfig(pts=32, nparts=4), nch)._asdict().items()}
    fields["wp"] = np.asarray([1, 2, 3], np.int32)
    fields["wp2"] = np.asarray([0, 5, -1], np.int32)
    moved = pconv_state_from_numpy(fields, "cpu")
    assert moved.wp == (1, 2, 3) and moved.wp2 == (0, 1, 3)
    assert moved.spec_x_re.shape == (nch, 8, 32)


def test_per_channel_pointers_that_differ_match_single_channel_streams():
    """Channels that have streamed different numbers of blocks (so their wp
    and wp2 differ) continue in one batched call exactly as each would in
    its own single-channel stream."""
    pts, nparts, nch = 16, 5, 3
    cfg = P.PconvConfig(pts=pts, nparts=nparts)
    rng = np.random.default_rng(12)
    singles = []
    for c in range(nch):
        ir = torch.from_numpy(rng.standard_normal(pts * nparts).astype(np.float32))
        st = P.push_ir(cfg, P.pconv_init(cfg, "cpu"), ir)
        pre = torch.from_numpy(rng.standard_normal((2 * c + 1, 2, pts)).astype(np.float32))
        st, _ = P.pconv_stream_tv(cfg, st, pre[:, 0], pre[:, 1])
        singles.append(st)
    stack = P.PconvState(*(torch.stack([getattr(s, n) for s in singles])
                           for n in RINGS + ("tail",)),
                         wp=tuple(s.wp for s in singles), wp2=tuple(s.wp2 for s in singles))
    assert len(set(stack.wp)) == nch and len(set(stack.wp2)) == nch
    bx = torch.from_numpy(rng.standard_normal((11, nch, pts)).astype(np.float32))
    bh = torch.from_numpy(rng.standard_normal((11, nch, pts)).astype(np.float32))
    lti, out_lti = P.pconv_stream_batched(cfg, stack, bx)
    tv, out_tv = P.pconv_stream_batched_tv(cfg, stack, bx, bh)
    for c, st in enumerate(singles):
        s1, o1 = P.pconv_stream(cfg, st, bx[:, c])
        _close(out_lti[:, c], o1, 2e-5)
        assert lti.wp[c] == s1.wp
        _close(lti.spec_x_re[c], s1.spec_x_re, 1e-5)
        s2, o2 = P.pconv_stream_tv(cfg, st, bx[:, c], bh[:, c])
        _close(out_tv[:, c], o2, 2e-5)
        assert (tv.wp[c], tv.wp2[c]) == (s2.wp, s2.wp2)
        for name in RINGS:
            _close(getattr(tv, name)[c], getattr(s2, name), 1e-5)
        _close(tv.tail[c], s2.tail, 2e-5)


@pytest.mark.parametrize("tv", [False, True])
def test_batched_steps_match_jax_vmapped_steps(tv):
    pts, nparts, nch = 32, 4, 3
    jcfg, tcfg = _configs(pts, nparts)
    rng = np.random.default_rng(13 + tv)
    js, ts = _seeded(jcfg, tcfg, nch, rng)
    step = JM._vmapped(J.pconv_step_tv if tv else J.pconv_step, jcfg)
    for _ in range(2 * nparts + 1):
        bx = rng.standard_normal((nch, pts)).astype(np.float32)
        bh = rng.standard_normal((nch, pts)).astype(np.float32)
        if tv:
            js, jo = step(js, jnp.asarray(bx), jnp.asarray(bh))
            ts, to = P.pconv_step_tv(tcfg, ts, torch.from_numpy(bx), torch.from_numpy(bh))
        else:
            js, jo = step(js, jnp.asarray(bx))
            ts, to = P.pconv_step(tcfg, ts, torch.from_numpy(bx))
        _close(to, jo, 2e-5)
    _assert_state_close(ts, js)


def test_batched_streams_validate_and_pass_empty_scans():
    cfg = P.PconvConfig(pts=16, nparts=3)
    st = batched_state(cfg, 2, "cpu")
    before = (S.BATCHED_LAUNCHES, S.BATCHED_TV_LAUNCHES)
    s2, empty = P.pconv_stream_batched(cfg, st, torch.zeros((0, 2, 16)))
    assert empty.shape == (0, 2, 16) and s2 is st
    s2, empty = P.pconv_stream_batched_tv(cfg, st, torch.zeros((0, 2, 16)),
                                          torch.zeros((0, 2, 16)))
    assert empty.shape == (0, 2, 16) and s2 is st
    P.pconv_stream_batched(cfg, st, torch.zeros((3, 2, 16)))
    assert (S.BATCHED_LAUNCHES, S.BATCHED_TV_LAUNCHES) == before   # the CPU runs twins
    with pytest.raises(ValueError, match=r"blocks must be \(nblocks, 2, 16\)"):
        P.pconv_stream_batched(cfg, st, torch.zeros((3, 3, 16)))
    with pytest.raises(ValueError, match="blocks_h"):
        P.pconv_stream_batched_tv(cfg, st, torch.zeros((3, 2, 16)), torch.zeros((2, 2, 16)))
    with pytest.raises(ValueError, match="one pointer per channel"):
        P.pconv_stream_batched(cfg, st._replace(wp=(0, 1, 2)), torch.zeros((3, 2, 16)))
    with pytest.raises(ValueError, match="batched state"):
        P.pconv_stream_batched(cfg, P.pconv_init(cfg, "cpu"), torch.zeros((3, 1, 16)))
    z = torch.zeros
    w = (z(2, 4, 16), z(2, 4, 16))
    with pytest.raises(ValueError, match="tails"):
        S.stream_steps_fused_batched(z(3, 2, 16), w, w, 1.0, z(16), 16)
    with pytest.raises(ValueError, match="h planes"):
        S.stream_steps_fused_batched(z(3, 3, 16), w, w, 1.0, z(3, 16), 16)
    with pytest.raises(ValueError, match="wp2 needs one pointer per channel"):
        S.stream_steps_fused_batched_tv(z(3, 2, 16), z(3, 2, 16), w, w, (0, 1, 2), 1.0,
                                        z(2, 16), 16)
    meta = torch.zeros((3, 2, 16), device="meta")
    with pytest.raises(ValueError, match="one device"):
        S.stream_steps_fused_batched(meta, w, w, 1.0, z(2, 16), 16)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the batched kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pts,nparts,nb,nch", [(2, 3, 5, 2), (4, 1, 2, 1), (64, 37, 70, 2),
                                               (128, 3, 130, 1), (256, 63, 65, 3),
                                               (1024, 16, 129, 2), (2048, 64, 117, 4)])
def test_cuda_batched_kernels_match_twins_at_edge_shapes(cuda_device, pts, nparts, nb, nch):
    """nb not a multiple of a MAC tile, nparts below MAC_TT and not a
    multiple of a stage, pts 2..2048, per-channel pointers: kernels against
    twins, and the same bits from a second launch."""
    d = _inputs(13 * nb + nparts + nch, pts, nparts, nb, nch)
    wp2 = tuple((5 * c + 2) % nparts for c in range(nch))
    got = _run(d, 1.0, pts, fn=S.stream_steps_fused_batched, device=cuda_device)
    again = _run(d, 1.0, pts, fn=S.stream_steps_fused_batched, device=cuda_device)
    got_tv = _run_tv(d, wp2, 1.0, pts, fn=S.stream_steps_fused_batched_tv, device=cuda_device)
    again_tv = _run_tv(d, wp2, 1.0, pts, fn=S.stream_steps_fused_batched_tv,
                       device=cuda_device)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got + got_tv, again + again_tv))
    _assert_scan_close(got, _run(d, 1.0, pts, device=cuda_device))
    _assert_scan_close(got_tv, _run_tv(d, wp2, 1.0, pts, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("pts,nparts,nb,nch", [(16, 1, 1, 2), (64, 5, 21, 3),
                                               (128, 8, 3, 1), (512, 256, 40, 4)])
@pytest.mark.parametrize("b0", [1.0, 2.0])
def test_cuda_batched_kernels_match_twins(cuda_device, pts, nparts, nb, nch, b0):
    d = _inputs(7 * nb + nparts + nch, pts, nparts, nb, nch)
    before = (S.BATCHED_LAUNCHES, S.BATCHED_TV_LAUNCHES)
    got = _run(d, b0, pts, fn=S.stream_steps_fused_batched, device=cuda_device)
    wp2 = tuple((5 * c + 2) % nparts for c in range(nch))
    got_tv = _run_tv(d, wp2, b0, pts, fn=S.stream_steps_fused_batched_tv,
                     device=cuda_device)
    torch.cuda.synchronize()
    assert (S.BATCHED_LAUNCHES, S.BATCHED_TV_LAUNCHES) == (before[0] + 1, before[1] + 1)
    _assert_scan_close(got, _run(d, b0, pts, device=cuda_device))
    _assert_scan_close(got_tv, _run_tv(d, wp2, b0, pts, device=cuda_device))
