"""The port's checkpoints (``opencl_fft_tpu_torch/utils/checkpoint.py``) in the
JAX package's npz layout, on the CPU: a round trip of every state type
(LTI and TV ``PconvState``, batched with per-channel pointers, bf16 rings,
float64, ``XfadeState``, ``DconvState``, ``ZLState``) continues the stream
bit for bit; a checkpoint saved by the JAX package continues in the port
within 1e-5 of the output scale of JAX's own continuation, and one saved by
the port continues in JAX the same way; leaf-count and shape mismatches
raise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_fft_tpu.models import lowlatency as JL
from opencl_fft_tpu.ops import dconv as JD
from opencl_fft_tpu.ops import pconv as JP
from opencl_fft_tpu.utils import checkpoint as jckpt
from opencl_fft_tpu_torch.models import ZeroLatencyConvolver, batched_state
from opencl_fft_tpu_torch.ops import dconv as D
from opencl_fft_tpu_torch.ops import pconv as P
from opencl_fft_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)
RNG = np.random.default_rng(5)


def _f(*shape, s=1.0):
    return (s * RNG.standard_normal(shape)).astype(np.float32)


def _same(a, b):
    for x, y in zip(ckpt._leaves(a), ckpt._leaves(b)):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)
        else:
            assert x == y and type(x) is type(y)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("kw", [{}, {"ring_dtype": "bf16"}, {"dtype": "f64"}],
                         ids=["f32", "bf16", "f64"])
@pytest.mark.parametrize("tv", [False, True])
def test_pconv_round_trip_continues_bit_exact(tmp_path, kw, tv):
    cfg = P.PconvConfig.for_ir_length(128 * 8, 128, **kw)
    st = P.push_ir(cfg, P.pconv_init(cfg, "cpu"), torch.from_numpy(_f(cfg.cvs)))
    step = (lambda s, b: P.pconv_step_tv(cfg, s, b, b.flip(0))) if tv else \
        (lambda s, b: P.pconv_step(cfg, s, b))
    blocks = torch.from_numpy(_f(12, 128))
    for b in blocks[:5]:
        st, _ = step(st, b)
    path = str(tmp_path / "st.npz")
    ckpt.save_state(path, st, meta={"pts": 128, "tv": tv})
    back = ckpt.load_state(path, P.pconv_init(cfg, "cpu"))
    _same(back, st)
    assert ckpt.load_meta(path) == {"pts": 128, "tv": tv}
    for b in blocks[5:]:
        st, o1 = step(st, b)
        back, o2 = step(back, b)
        assert torch.equal(o1, o2)


def test_batched_per_channel_pointers_round_trip(tmp_path):
    cfg = P.PconvConfig.for_ir_length(64 * 4, 64)
    st = batched_state(cfg, 3, "cpu")
    st = st._replace(spec_x_re=torch.from_numpy(_f(3, 8, 64)), wp=(0, 2, 3), wp2=(1, 0, 3))
    path = str(tmp_path / "b.npz")
    ckpt.save_state(path, st)
    with np.load(path) as d:
        assert d["leaf_5"].dtype == np.int32 and d["leaf_5"].shape == (3,)
    back = ckpt.load_state(path, batched_state(cfg, 3, "cpu"))
    _same(back, st)


def test_xfade_dconv_zl_round_trip(tmp_path):
    cfg = P.PconvConfig.for_ir_length(64 * 4, 64)
    st = P.push_ir(cfg, P.pconv_init(cfg, "cpu"), torch.from_numpy(_f(cfg.cvs)))
    xf = P.pconv_begin_xfade(cfg, st, torch.from_numpy(_f(cfg.cvs)))
    dcfg = D.DconvConfig(irsize=50, vsize=16)
    dst = D.push_ir(dcfg, D.dconv_init(dcfg, "cpu"), torch.from_numpy(_f(50)))
    dst, _ = D.dconv_step(dcfg, dst, torch.from_numpy(_f(16)))
    zl_ir = _f(900)
    zl = ZeroLatencyConvolver(zl_ir, block=64, pmax=256, device="cpu")
    blocks = _f(10, 64)
    for b in blocks[:4]:
        zl.process(b)
    for i, (state, like) in enumerate(((xf, P.pconv_begin_xfade(cfg, P.pconv_init(cfg, "cpu"),
                                                                torch.zeros(cfg.cvs))),
                                       (dst, D.dconv_init(dcfg, "cpu")),
                                       (zl.state, ZeroLatencyConvolver(
                                           np.ones(900, np.float32), block=64, pmax=256,
                                           device="cpu").state))):
        path = str(tmp_path / f"s{i}.npz")
        ckpt.save_state(path, state)
        _same(ckpt.load_state(path, like), state)
    zl2 = ZeroLatencyConvolver(zl_ir, block=64, pmax=256, device="cpu")
    zl2.state = ckpt.load_state(str(tmp_path / "s2.npz"), zl2.state)
    for b in blocks[4:]:
        np.testing.assert_array_equal(zl2.process(b), zl.process(b))


def test_mismatches_raise(tmp_path):
    cfg = P.PconvConfig.for_ir_length(64 * 4, 64)
    path = str(tmp_path / "x.npz")
    ckpt.save_state(path, P.pconv_init(cfg, "cpu"))
    other = P.PconvConfig.for_ir_length(64 * 8, 64)
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_state(path, P.pconv_init(other, "cpu"))
    with pytest.raises(ValueError, match="leaves"):
        ckpt.load_state(path, P.pconv_begin_xfade(cfg, P.pconv_init(cfg, "cpu"),
                                                  torch.zeros(cfg.cvs)))
    ckpt.save_state(path, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.load_state(path, {"a": torch.zeros(3), "b": torch.zeros(2)})


def _jax_step(jcfg, tv):
    if tv:
        return lambda s, b: JP.pconv_step_tv(jcfg, s, b, b[::-1])
    return lambda s, b: JP.pconv_step(jcfg, s, b)


@pytest.mark.parametrize("tv", [False, True])
def test_jax_checkpoint_continues_in_the_port(tmp_path, tv):
    cfg = P.PconvConfig.for_ir_length(128 * 8, 128)
    jcfg = JP.PconvConfig.for_ir_length(128 * 8, 128)
    ir = _f(cfg.cvs, s=0.1)
    blocks = _f(14, 128)
    jstep = _jax_step(jcfg, tv)
    jst = JP.push_ir(jcfg, JP.pconv_init(jcfg), jnp.asarray(ir))
    for b in blocks[:6]:
        jst, _ = jstep(jst, jnp.asarray(b))
    path = str(tmp_path / "j.npz")
    jckpt.save_state(path, jst, meta={"from": "jax"})
    st = ckpt.load_state(path, P.pconv_init(cfg, "cpu"))
    assert ckpt.load_meta(path) == {"from": "jax"}
    assert (st.wp, st.wp2) == (int(jst.wp), int(jst.wp2))
    got, want = [], []
    for b in blocks[6:]:
        st, o = (P.pconv_step_tv(cfg, st, torch.from_numpy(b), torch.from_numpy(b[::-1].copy()))
                 if tv else P.pconv_step(cfg, st, torch.from_numpy(b)))
        jst, jo = jstep(jst, jnp.asarray(b))
        got.append(o.numpy())
        want.append(np.asarray(jo))
    assert _rel(np.concatenate(got), np.concatenate(want)) <= 1e-5


@pytest.mark.parametrize("tv", [False, True])
def test_port_checkpoint_continues_in_jax(tmp_path, tv):
    cfg = P.PconvConfig.for_ir_length(128 * 8, 128)
    jcfg = JP.PconvConfig.for_ir_length(128 * 8, 128)
    ir = _f(cfg.cvs, s=0.1)
    blocks = _f(14, 128)
    st = P.push_ir(cfg, P.pconv_init(cfg, "cpu"), torch.from_numpy(ir))
    for b in blocks[:6]:
        st, _ = (P.pconv_step_tv(cfg, st, torch.from_numpy(b), torch.from_numpy(b[::-1].copy()))
                 if tv else P.pconv_step(cfg, st, torch.from_numpy(b)))
    path = str(tmp_path / "t.npz")
    ckpt.save_state(path, st)
    jst = jckpt.load_state(path, JP.pconv_init(jcfg))
    jstep = _jax_step(jcfg, tv)
    got, want = [], []
    for b in blocks[6:]:
        st, o = (P.pconv_step_tv(cfg, st, torch.from_numpy(b), torch.from_numpy(b[::-1].copy()))
                 if tv else P.pconv_step(cfg, st, torch.from_numpy(b)))
        jst, jo = jstep(jst, jnp.asarray(b))
        got.append(o.numpy())
        want.append(np.asarray(jo))
    assert _rel(np.concatenate(want), np.concatenate(got)) <= 1e-5


def test_dconv_and_zl_checkpoints_cross_both_ways(tmp_path):
    """DconvState and the zero-latency ZLState (its int counter, the head's
    dconv state, per segment the engine state, buffer and queue) saved by
    either package load into the other and continue within 1e-5."""
    ir = _f(700, s=0.1)
    blocks = _f(16, 64)
    zl = ZeroLatencyConvolver(ir, block=64, pmax=256, device="cpu")
    jzl = JL.ZeroLatencyConvolver(ir, block=64, pmax=256)
    for b in blocks[:7]:
        zl.process(b)
        jzl.process(b)
    pj, pt = str(tmp_path / "zj.npz"), str(tmp_path / "zt.npz")
    jckpt.save_state(pj, jzl.state)
    ckpt.save_state(pt, zl.state)
    zl_from_j = ZeroLatencyConvolver(ir, block=64, pmax=256, device="cpu")
    zl_from_j.state = ckpt.load_state(pj, zl_from_j.state)
    jzl_from_t = JL.ZeroLatencyConvolver(ir, block=64, pmax=256)
    jzl_from_t.state = jckpt.load_state(pt, jzl_from_t.state)
    assert zl_from_j.state.t == int(jzl.state.t) == zl.state.t
    for b in blocks[7:]:
        want = np.asarray(jzl.process(b))
        for got in (zl_from_j.process(b), np.asarray(jzl_from_t.process(b)), zl.process(b)):
            assert _rel(got, want) <= 1e-5
    dcfg, jdcfg = D.DconvConfig(irsize=50, vsize=16), JD.DconvConfig(irsize=50, vsize=16)
    k = _f(50)
    dst = D.push_ir(dcfg, D.dconv_init(dcfg, "cpu"), torch.from_numpy(k))
    dst, _ = D.dconv_step(dcfg, dst, torch.from_numpy(blocks[0, :16]))
    ckpt.save_state(pt, dst)
    jdst = jckpt.load_state(pt, JD.dconv_init(jdcfg))
    back = ckpt.load_state(pt, D.dconv_init(dcfg, "cpu"))
    b = blocks[1, :16]
    _, o = D.dconv_step(dcfg, back, torch.from_numpy(b))
    _, jo = JD.dconv_step(jdcfg, jdst, jnp.asarray(b))
    assert _rel(o.numpy(), np.asarray(jo)) <= 1e-5
    assert len(jax.tree.leaves(jdst)) == len(ckpt._leaves(dst)) == 3
