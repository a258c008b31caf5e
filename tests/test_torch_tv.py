"""Port parity: the time-varying partitioned path of opencl_fft_tpu_torch
against opencl_fft_tpu on the same inputs.

The plain twin ``stream_steps_fused_tv_plain`` is held against the JAX Pallas
kernel ``stream_steps_fused_tv`` in interpret mode (outputs and tail atol
2e-5 * max|ref|, the JAX package's stream-vs-scan tolerance; final window
and h ring atol 1e-5 * max|ring|). ``pconv_step_tv`` and ``pconv_stream_tv``
are held against the JAX ``pconv_stream_tv`` through its XLA scan
(pallas="off"), the class and opcode layers against their JAX counterparts,
at the same tolerances. The CUDA kernel is held against the twin on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal as sps

from opencl_fft_tpu import api as japi
from opencl_fft_tpu import stream as jstream
from opencl_fft_tpu.ops import pconv as J
from opencl_fft_tpu.ops.pallas.streamstep import \
    stream_steps_fused_tv as jax_stream_steps_fused_tv
from opencl_fft_tpu_torch import api as tapi
from opencl_fft_tpu_torch import stream as tstream
from opencl_fft_tpu_torch.interop import (pconv_state_from_numpy,
                                          pconv_state_to_numpy)
from opencl_fft_tpu_torch.ops import pconv as P
from opencl_fft_tpu_torch.ops.cuda import streamstep as S

torch.set_num_threads(1)

RINGS = ("spec_x_re", "spec_x_im", "spec_h_re", "spec_h_im")


def _quiet(msg, user_data):
    pass


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, ref, rel):
    ref = _np(ref)
    np.testing.assert_allclose(_np(got), ref, atol=rel * (np.abs(ref).max() + 1e-30),
                               rtol=0)


def _inputs(seed, pts, nparts, nb):
    rng = np.random.default_rng(seed)

    def f(*shape, s=1.0):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    return dict(bx=f(nb, pts), bh=f(nb, pts, s=0.2), w0r=f(nparts, pts),
                w0i=f(nparts, pts), h0r=f(nparts, pts, s=0.2),
                h0i=f(nparts, pts, s=0.2), tail=f(pts))


def _run_tv(d, wp2, b0, pts, fn=S.stream_steps_fused_tv_plain, device="cpu"):
    t = {k: torch.from_numpy(v).to(device) for k, v in d.items()}
    outs, (wr, wi), (hr, hi), tail = fn(t["bx"], t["bh"], (t["w0r"], t["w0i"]),
                                        (t["h0r"], t["h0i"]), wp2, b0, t["tail"], pts)
    return outs, wr, wi, hr, hi, tail


def _assert_tv_close(got, ref):
    outs, wr, wi, hr, hi, tail = got
    r_outs, r_wr, r_wi, r_hr, r_hi, r_tail = ref
    _close(outs, r_outs, 2e-5)
    _close(tail, r_tail, 2e-5)
    for g, r in ((wr, r_wr), (wi, r_wi), (hr, r_hr), (hi, r_hi)):
        _close(g, r, 1e-5)


@pytest.mark.parametrize("pts,nparts", [(64, 4), (64, 8), (128, 4), (128, 8)])
@pytest.mark.parametrize("nb", [8, 16])
@pytest.mark.parametrize("b0", [1.0, 2.0])
@pytest.mark.parametrize("wp2_last", [True, False])
def test_tv_twin_matches_pallas_kernel(pts, nparts, nb, b0, wp2_last):
    wp2 = nparts - 1 if wp2_last else 1
    d = _inputs(pts + nparts + nb, pts, nparts, nb)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    blocks2 = jnp.stack([j["bx"], j["bh"]], axis=1).reshape(2 * nb, pts)
    outs, (wr, wi), (hr, hi), tail = jax_stream_steps_fused_tv(
        blocks2, (j["w0r"], j["w0i"]), (j["h0r"], j["h0i"]), wp2, b0, j["tail"],
        pts, interpret=True)
    _assert_tv_close(_run_tv(d, wp2, b0, pts), (outs, wr, wi, hr, hi, tail))


def _sequential_tv(d, wp2, b0, pts):
    """Literal ring-write model of the TV scan (the JAX kernel's order of
    operations), in float64 numpy: the ground truth of the timeline form."""
    from opencl_fft_tpu_torch.ops.cuda.tables import _wfwd_np, _wpost_np

    nparts = d["h0r"].shape[0]
    wf = _wfwd_np(pts).astype(np.float64)
    wpost = _wpost_np(pts).astype(np.float64)
    w = d["w0r"].astype(np.float64) + 1j * d["w0i"]
    h = d["h0r"].astype(np.float64) + 1j * d["h0i"]
    tail = d["tail"].astype(np.float64)
    outs = []
    for t in range(d["bx"].shape[0]):
        fx, fh = d["bx"][t] @ wf, d["bh"][t] @ wf
        h[(wp2 - t) % nparts] = fh[:pts] + 1j * fh[pts:]
        w = np.concatenate([w[1:], (fx[:pts] + 1j * fx[pts:])[None]])
        acc = (w * h).sum(0)
        acc[0] = b0 * ((w.real[:, 0] * h.real[:, 0]).sum()
                       + 1j * (w.imag[:, 0] * h.imag[:, 0]).sum())
        y = np.concatenate([acc.real, acc.imag]) @ wpost
        outs.append((y[:pts] + tail) / pts)
        tail = y[pts:]
    return np.stack(outs), w.real, w.imag, h.real, h.imag, tail


@pytest.mark.parametrize("pts,nparts,nb,wp2", [(16, 1, 3, 0), (16, 4, 2, 1),
                                               (16, 5, 13, 2), (32, 7, 9, 6),
                                               (16, 7, 30, 0)])
def test_tv_twin_matches_sequential_ring(pts, nparts, nb, wp2):
    """Shapes the JAX kernel does not take (nb < nparts, nparts = 1, nb not
    a multiple of 8) against the literal ring-write model."""
    d = _inputs(nb * nparts, pts, nparts, nb)
    _assert_tv_close(_run_tv(d, wp2, 2.0, pts), _sequential_tv(d, wp2, 2.0, pts))


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
    assert got.wp == int(ref.wp) and got.wp2 == int(ref.wp2)


def _seeded_states(jcfg, tcfg, rng):
    ir = (0.3 * rng.standard_normal(tcfg.cvs)).astype(np.float32)
    return (J.push_ir(jcfg, J.pconv_init(jcfg), jnp.asarray(ir)),
            P.push_ir(tcfg, P.pconv_init(tcfg, "cpu"), torch.from_numpy(ir)))


@pytest.mark.parametrize("bin0_mode", ["exact", "compat"])
@pytest.mark.parametrize("pts,nparts", [(64, 4), (32, 5)])
def test_step_tv_matches_jax(pts, nparts, bin0_mode):
    jcfg, tcfg = _configs(pts, nparts, bin0_mode)
    rng = np.random.default_rng(pts + nparts)
    js, ts = _seeded_states(jcfg, tcfg, rng)
    for _ in range(2 * nparts + 1):
        bx = rng.standard_normal(pts).astype(np.float32)
        bh = rng.standard_normal(pts).astype(np.float32)
        js, jo = J.pconv_step_tv(jcfg, js, jnp.asarray(bx), jnp.asarray(bh))
        ts, to = P.pconv_step_tv(tcfg, ts, torch.from_numpy(bx), torch.from_numpy(bh))
        _close(to, jo, 2e-5)
    _assert_state_close(ts, js)


@pytest.mark.parametrize("pts,nparts,nb", [(64, 4, 13), (32, 5, 3)])
def test_stream_tv_matches_jax_over_chained_calls(pts, nparts, nb):
    """Two chained calls, then the state crosses to JAX through interop and
    back, and both packages continue on the same blocks."""
    jcfg, tcfg = _configs(pts, nparts)
    rng = np.random.default_rng(nb)
    js, ts = _seeded_states(jcfg, tcfg, rng)
    bx = rng.standard_normal((4, nb, pts)).astype(np.float32)
    bh = (0.3 * rng.standard_normal((4, nb, pts))).astype(np.float32)
    for call in range(2):
        js, jo = J.pconv_stream_tv(jcfg, js, jnp.asarray(bx[call]), jnp.asarray(bh[call]))
        ts, to = P.pconv_stream_tv(tcfg, ts, torch.from_numpy(bx[call]),
                                   torch.from_numpy(bh[call]))
        assert to.shape == (nb, pts)
        _close(to, jo, 2e-5)
        _assert_state_close(ts, js)
    back = J.PconvState(**{k: jnp.asarray(v) for k, v in pconv_state_to_numpy(ts).items()})
    js_b, jo_b = J.pconv_stream_tv(jcfg, back, jnp.asarray(bx[2]), jnp.asarray(bh[2]))
    js, jo = J.pconv_stream_tv(jcfg, js, jnp.asarray(bx[2]), jnp.asarray(bh[2]))
    _close(jo_b, jo, 2e-5)
    ts = pconv_state_from_numpy(J.PconvState(*(np.asarray(f) for f in js)), "cpu")
    js, jo = J.pconv_stream_tv(jcfg, js, jnp.asarray(bx[3]), jnp.asarray(bh[3]))
    ts, to = P.pconv_stream_tv(tcfg, ts, torch.from_numpy(bx[3]), torch.from_numpy(bh[3]))
    _close(to, jo, 2e-5)
    _assert_state_close(ts, js)


def test_stream_tv_equals_steps_and_validates():
    cfg = P.PconvConfig(pts=16, nparts=3)
    rng = np.random.default_rng(5)
    st = P.push_ir(cfg, P.pconv_init(cfg, "cpu"),
                   torch.from_numpy(rng.standard_normal(48).astype(np.float32)))
    bx = torch.from_numpy(rng.standard_normal((7, 16)).astype(np.float32))
    bh = torch.from_numpy(rng.standard_normal((7, 16)).astype(np.float32))
    before = S.BATCHED_TV_LAUNCHES
    s_stream, outs = P.pconv_stream_tv(cfg, st, bx, bh)
    assert S.BATCHED_TV_LAUNCHES == before              # the CPU runs the twin
    steps = []
    for x, h in zip(bx, bh):
        st, o = P.pconv_step_tv(cfg, st, x, h)
        steps.append(o)
    _close(outs, torch.stack(steps), 2e-5)
    _assert_state_close(s_stream, st)
    s_empty, empty = P.pconv_stream_tv(cfg, s_stream, torch.zeros((0, 16)),
                                       torch.zeros((0, 16)))
    assert empty.shape == (0, 16) and s_empty is s_stream
    with pytest.raises(ValueError, match="blocks_h"):
        P.pconv_stream_tv(cfg, st, bx, bh[:6])
    with pytest.raises(ValueError, match="blocks_x"):
        P.pconv_stream_tv(cfg, st, bx[0], bh[0])


def test_cyclic_ir_stream_equals_lti_convolution():
    """Feeding the IR's partitions cyclically through operand 2 after
    push_ir keeps the ring in the push_ir layout, so the TV stream equals
    the full linear convolution (tests/test_stream.py's identity)."""
    pts, nparts = 32, 4
    cfg = P.PconvConfig(pts=pts, nparts=nparts)
    rng = np.random.default_rng(8)
    ir = rng.standard_normal(pts * nparts).astype(np.float32)
    x = rng.standard_normal(300).astype(np.float32)
    nb = -(-(x.size + ir.size) // pts)
    xb = np.zeros(nb * pts, np.float32)
    xb[:x.size] = x
    hb = np.stack([ir.reshape(nparts, pts)[i % nparts] for i in range(nb)])
    st = P.push_ir(cfg, P.pconv_init(cfg, "cpu"), torch.from_numpy(ir))
    _, y = P.pconv_stream_tv(cfg, st, torch.from_numpy(xb.reshape(nb, pts)),
                             torch.from_numpy(hb))
    ref = sps.fftconvolve(x.astype(np.float64), ir.astype(np.float64))
    _close(y.reshape(-1)[:ref.size], ref, 3e-5)


def test_wrapper_checks_arguments_and_devices():
    z = torch.zeros
    w = (z(4, 16), z(4, 16))
    with pytest.raises(ValueError, match="blocks_h"):
        S.stream_steps_fused_tv(z(3, 16), z(2, 16), w, w, 0, 1.0, z(16), 16)
    with pytest.raises(ValueError, match="tail"):
        S.stream_steps_fused_tv(z(3, 16), z(3, 16), w, w, 0, 1.0, z(8), 16)
    meta = torch.zeros((3, 16), device="meta")
    with pytest.raises(ValueError, match="one device"):
        S.stream_steps_fused_tv(z(3, 16), meta, w, w, 0, 1.0, z(16), 16)
    mw = (torch.zeros((4, 16), device="meta"),) * 2
    with pytest.raises(ValueError, match="no kernel"):
        S.stream_steps_fused_tv(meta, meta, mw, mw, 0, 1.0,
                                torch.zeros(16, device="meta"), 16)


def test_clpconv_tv_matches_jax():
    cvs, pts = 128, 32
    rng = np.random.default_rng(2)
    j = japi.Clpconv(0, cvs, pts, _quiet)
    t = tapi.Clpconv(0, cvs, pts, _quiet, device="cpu")
    for _ in range(9):
        a = rng.standard_normal(pts).astype(np.float32)
        b = rng.standard_normal(pts).astype(np.float32)
        jo, to = np.empty(pts, np.float32), np.empty(pts, np.float32)
        assert j.convolution(jo, a, b) == t.convolution(to, a, b) == 0
        _close(to, jo, 2e-5)


def _drive_tv(proc, a, b, host_block, freeze=lambda i: (None, None)):
    outs = []
    for n, i in enumerate(range(0, a.size, host_block)):
        f1, f2 = freeze(n)
        outs.append(proc.process(a[i:i + host_block], b[i:i + host_block],
                                 freeze1=f1, freeze2=f2))
    return np.concatenate(outs)


@pytest.mark.parametrize("which", ["freeze1", "freeze2"])
def test_tvconv_processor_freezes_match_jax(which):
    """Ragged host blocks with each operand frozen for a stretch, and a
    0dbfs scale: the same output as the JAX processor."""
    parts, size, scale = 16, 64, 4.0
    rng = np.random.default_rng(3)
    a = rng.standard_normal(700).astype(np.float32)
    b = rng.standard_normal(700).astype(np.float32)

    def freeze(n):
        hold = False if 10 <= n < 25 else True
        return (hold, None) if which == "freeze1" else (None, hold)

    jp = jstream.CltvconvProcessor(parts, size, scale=scale, on_message=_quiet)
    tp = tstream.CltvconvProcessor(parts, size, scale=scale, on_message=_quiet,
                                   device="cpu")
    jo, to = _drive_tv(jp, a, b, 23, freeze), _drive_tv(tp, a, b, 23, freeze)
    _close(to, jo, 2e-5)
    assert (tp.freeze1, tp.freeze2) == (jp.freeze1, jp.freeze2) == (True, True)


def test_tvconv_processor_0dbfs_scaling():
    parts = 16
    rng = np.random.default_rng(4)
    a = rng.standard_normal(parts).astype(np.float32)
    h = rng.standard_normal(parts).astype(np.float32)
    tv1 = tstream.CltvconvProcessor(parts, parts * 2, scale=1.0, device="cpu")
    tv2 = tstream.CltvconvProcessor(parts, parts * 2, scale=32768.0, device="cpu")
    o1 = [tv1.process(a, h) for _ in range(3)][-1]
    o2 = [tv2.process(a, h) for _ in range(3)][-1]
    np.testing.assert_allclose(o2 * 32768.0, o1, rtol=1e-4, atol=1e-6)


def test_tvconv_processor_cyclic_ir_identity():
    """cltvconv fed the IR cyclically equals clconv against that IR,
    delayed by one partition (tests/test_stream.py's identity)."""
    parts, nparts = 32, 4
    size = parts * nparts
    rng = np.random.default_rng(6)
    ir = rng.standard_normal(size).astype(np.float32)
    x = rng.standard_normal(size * 4).astype(np.float32)
    tp = tstream.CltvconvProcessor(parts, size, device="cpu")
    got = _drive_tv(tp, x, np.tile(ir, 4), 50)
    full = sps.fftconvolve(x, ir)
    expect = np.concatenate([np.zeros(parts, np.float32), full])[:got.size]
    _close(got, expect, 5e-5)


def test_tvconv_processor_direct_branch_matches_jax():
    rng = np.random.default_rng(7)
    jp = jstream.CltvconvProcessor(parts=1, size=24, block_size=16, on_message=_quiet)
    tp = tstream.CltvconvProcessor(parts=1, size=24, block_size=16, on_message=_quiet,
                                   device="cpu")
    assert tp.dconv and jp.dconv
    for n in range(6):
        a = rng.standard_normal(16).astype(np.float32)
        b = rng.standard_normal(16).astype(np.float32)
        f1 = False if n == 3 else None
        f2 = False if n == 4 else (True if n == 5 else None)
        _close(tp.process(a, b, f1, f2), jp.process(a, b, f1, f2), 2e-5)
    with pytest.raises(tstream.ArgumentError):
        tp.process(np.zeros(8, np.float32), np.zeros(8, np.float32))


def test_tvconv_processor_bad_args():
    with pytest.raises(tstream.ArgumentError):
        tstream.CltvconvProcessor(parts=8, size=12, device="cpu")
    with pytest.raises(tstream.ArgumentError):
        tstream.CltvconvProcessor(parts=0, size=12, device="cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the TV kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pts,nparts,nb,wp2", [(16, 1, 1, 0), (64, 5, 21, 2),
                                               (128, 8, 3, 7), (512, 256, 40, 100)])
@pytest.mark.parametrize("b0", [1.0, 2.0])
def test_cuda_tv_kernel_matches_twin(cuda_device, pts, nparts, nb, wp2, b0):
    d = _inputs(7 * nb + nparts, pts, nparts, nb)
    before = S.BATCHED_TV_LAUNCHES
    got = _run_tv(d, wp2, b0, pts, fn=S.stream_steps_fused_tv, device=cuda_device)
    torch.cuda.synchronize()
    assert S.BATCHED_TV_LAUNCHES == before + 1
    _assert_tv_close(got, _run_tv(d, wp2, b0, pts, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("pts,nparts,nb,wp2", [(2, 3, 5, 1), (8, 9, 200, 4), (64, 37, 70, 3),
                                               (128, 3, 130, 2), (256, 63, 65, 62),
                                               (1024, 16, 21, 15), (2048, 64, 117, 63)])
def test_cuda_tv_kernel_matches_twin_at_edge_shapes(cuda_device, pts, nparts, nb, wp2):
    """nb not a multiple of a MAC tile, nparts below MAC_TT and not a
    multiple of a stage, pts 2..2048: kernel against twin, and the same
    bits from a second launch."""
    d = _inputs(11 * nb + nparts, pts, nparts, nb)
    got = _run_tv(d, wp2, 2.0, pts, fn=S.stream_steps_fused_tv, device=cuda_device)
    again = _run_tv(d, wp2, 2.0, pts, fn=S.stream_steps_fused_tv, device=cuda_device)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _assert_tv_close(got, _run_tv(d, wp2, 2.0, pts, device=cuda_device))


@pytest.mark.cuda
def test_cuda_stream_tv_matches_cpu_twin(cuda_device):
    cfg = P.PconvConfig(pts=64, nparts=5)
    rng = np.random.default_rng(10)
    ir = torch.from_numpy(rng.standard_normal(320).astype(np.float32))
    bx = torch.from_numpy(rng.standard_normal((2, 11, 64)).astype(np.float32))
    bh = torch.from_numpy(rng.standard_normal((2, 11, 64)).astype(np.float32))
    tc = P.push_ir(cfg, P.pconv_init(cfg, "cpu"), ir)
    tg = P.push_ir(cfg, P.pconv_init(cfg, cuda_device), ir.to(cuda_device))
    before = S.BATCHED_TV_LAUNCHES
    for call in range(2):
        tc, oc = P.pconv_stream_tv(cfg, tc, bx[call], bh[call])
        tg, og = P.pconv_stream_tv(cfg, tg, bx[call].to(cuda_device),
                                   bh[call].to(cuda_device))
        _close(og, oc, 2e-5)
    assert S.BATCHED_TV_LAUNCHES == before + 2


# ---------------------------------------------------------------------------
# the FFT-chain twin at every pts, and the tiled MAC's ring rows
# ---------------------------------------------------------------------------

PTS_ALL = [2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048]
B0 = [pytest.param(1.0, id="compat"), pytest.param(2.0, id="exact")]


@pytest.mark.parametrize("pts", PTS_ALL)
@pytest.mark.parametrize("b0", B0)
def test_fft_tv_twin_matches_pallas_kernel_at_every_pts(pts, b0):
    nparts, nb, wp2 = 3, 8, 1
    d = _inputs(5 * pts + int(b0), pts, nparts, nb)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    blocks2 = jnp.stack([j["bx"], j["bh"]], axis=1).reshape(2 * nb, pts)
    outs, (wr, wi), (hr, hi), tail = jax_stream_steps_fused_tv(
        blocks2, (j["w0r"], j["w0i"]), (j["h0r"], j["h0i"]), wp2, b0, j["tail"],
        pts, interpret=True)
    _assert_tv_close(_run_tv(d, wp2, b0, pts), (outs, wr, wi, hr, hi, tail))


def _tile_tv_rows(plan, nb, nparts, wp2):
    """The coefficient-timeline row the tiled TV MAC (``csrc/scan_mac.cuh``
    mac_stage / mac_chunk) multiplies into output t at partition q: each
    CTA stages row s0 + nparts - 1 (s0 the latest block <= t0 with s0 = wp2
    - q mod nparts) and, where a CTA output reaches s0 + nparts, the row
    after it; a warp's outputs take the second row once its phase wrapped,
    and its outputs j >= jw past its own wrap the row after the first."""
    rows = np.full((nb, nparts), -1)
    T, tt = plan.outs, plan.tt
    for t0 in range(0, nb, T):
        for q in range(nparts):
            m0 = (t0 - wp2 + q) % nparts
            s0 = t0 - m0
            staged = [s0 + nparts - 1,
                      s0 + 2 * nparts - 1 if s0 + nparts <= min(t0 + T, nb) - 1 else None]
            for g in range(plan.groups):
                mg = m0 + g * tt
                second = int(mg >= nparts)
                jw = nparts - (mg - nparts * second)
                for j in range(tt):
                    t = t0 + g * tt + j
                    if t < nb:
                        assert not (j >= jw and second)       # one wrap a warp at most
                        rows[t, q] = staged[1 if j >= jw else second]
    return rows


@pytest.mark.parametrize("nb,nparts,wp2", [(470, 256, 255), (1880, 256, 5), (70, 37, 3),
                                           (65, 63, 62), (9, 8, 7), (200, 9, 0), (21, 16, 15),
                                           (3, 8, 2), (130, 64, 63), (129, 128, 1)])
@pytest.mark.parametrize("tt,groups", [(8, 8), (8, 4), (8, 1), (16, 4), (16, 2), (16, 1)])
def test_tiled_tv_mac_reads_the_ring_rows_of_the_twin(nb, nparts, wp2, tt, groups):
    """Every output and partition of the tiled TV MAC multiplies the row
    the twin gathers (``_tv_rows``), at each plan the kernel may run
    (groups * tt <= nparts), and the row it reads was staged."""
    if groups * tt > nparts:
        groups = max(1, nparts // tt)
    if tt > nparts:
        tt, groups = 8, 1
    ring = 1 << (2 * 32 + groups * tt - 2).bit_length()
    plan = S.MacPlan(groups, tt, 32, ring)
    got = _tile_tv_rows(plan, nb, nparts, wp2)
    t, q = np.arange(nb)[:, None], np.arange(nparts)[None]
    np.testing.assert_array_equal(got, S._tv_rows(t, q, wp2, nparts))


def test_tv_mac_plan_keeps_a_tile_within_nparts():
    """The plan's TV tile spans no more blocks than there are partitions,
    so a tile's outputs read at most two coefficient rows a partition."""
    for nparts in (8, 9, 15, 16, 31, 63, 64, 256, 2048):
        for nb, bins, nch in ((1880, 512, 1), (470, 512, 64), (21, 64, 3), (1, 16, 1)):
            plan = S.mac_plan(nch, nb, bins, nparts, True)
            assert plan.outs <= nparts and plan.tt <= nparts
