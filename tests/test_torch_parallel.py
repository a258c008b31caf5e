"""Port parity: the sharded engines of opencl_fft_tpu_torch.parallel
(torch.distributed, gloo ranks on the CPU) against opencl_fft_tpu.parallel
on the 8 virtual CPU devices of tests/conftest.py, on the same inputs.

Every case of tests/test_parallel.py has a counterpart. One group of 8
ranks, spawned once for the module (``ranks``), runs every case: its
programs are in tests/test_torch_ranks.py, which imports the port only; the
JAX references run here. Sharded outputs are held against the JAX sharded
engine and the port's unsharded engine at 1e-4 of the output scale (the tp
all_reduce reorders the float32 partition sums), as the JAX tests hold
theirs.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P_
from scipy import signal as sps

import test_torch_ranks as R
from opencl_fft_tpu.ops import pconv as J
from opencl_fft_tpu.parallel import sharded as JS
from opencl_fft_tpu.parallel.mesh import make_mesh as jax_mesh
from opencl_fft_tpu_torch import models as M
from opencl_fft_tpu_torch.ops import pconv as P
from opencl_fft_tpu_torch.parallel import (Mesh, balanced_shape, dryrun_multichip,
                                           make_mesh, make_sharded_pconv_step,
                                           make_sharded_pconv_xfade)
from opencl_fft_tpu_torch.parallel.dryrun import run_ranks
from opencl_fft_tpu_torch.utils.errors import DeviceError

torch.set_num_threads(1)

SHAPES = [(2, 4), (4, 2), (1, 8), (8, 1)]
XFADE_SHAPES = [(2, 4), (4, 2)]
TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _inputs():
    """Every case's inputs, made from one seed."""
    rng = np.random.default_rng(11)

    def f(*shape, s=1.0):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    xf = dict(irs0=f(8, 256), ir_new=f(256), x=f(10, 8, 32))
    irs_new = np.zeros((8, 256), np.float32)
    irs_new[5] = xf["ir_new"]
    mask = np.zeros(8, bool)
    mask[5] = True
    xf.update(irs_new=irs_new, mask=mask)
    return dict(
        fft=(f(16, 256), f(16, 256)),
        lti={s: (f(8, 256), f(16, 8, 32)) for s in SHAPES},
        tv=(f(19, 2, 16), f(19, 2, 16)),
        repro=(f(2, 16), f(2, 16)),
        serving=(f(8, 256, s=0.2), f(12, 8, 32, s=0.1)),
        collectives=(f(3, 8, 32), f(3, 8, 32)),
        crossing=(f(8, 256), f(14, 8, 32)),
        xfade=xf)


def _jax_stream(shape, pts, nparts, irs, bx, bh=None, state=None):
    """The JAX sharded engine: (outs (batch, nblocks, pts), final state as
    numpy)."""
    mesh = jax_mesh(shape)
    cfg = J.PconvConfig.for_ir_length(pts * nparts, pts)
    sh = JS.state_shardings(mesh)
    st = JS.sharded_pconv_init(cfg, bx.shape[1]) if state is None else state
    st = {k: jax.device_put(jnp.asarray(v), sh[k]) for k, v in st.items()}
    if irs is not None:
        st = JS.sharded_push_ir(cfg, mesh, st, jax.device_put(
            jnp.asarray(irs), NamedSharding(mesh, P_("dp", None))))
    step = JS.make_sharded_pconv_step(cfg, mesh, tv=bh is not None)
    outs = []
    for b in range(bx.shape[0]):
        st, o = step(st, bx[b]) if bh is None else step(st, bx[b], bh[b])
        outs.append(np.asarray(o))
    return np.stack(outs, 1), {k: np.asarray(v) for k, v in st.items()}


def _unsharded(pts, nparts, irs, bx, bh=None):
    """The port's unsharded batched engine: (batch, nblocks, pts)."""
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts)
    st = M.batched_state(cfg, bx.shape[1], "cpu")
    if irs is not None:
        st = P.push_ir(cfg, st, torch.from_numpy(irs))
    if bh is None:
        _, out = P.pconv_stream_batched(cfg, st, torch.from_numpy(bx))
    else:
        _, out = P.pconv_stream_batched_tv(cfg, st, torch.from_numpy(bx), torch.from_numpy(bh))
    return out.numpy().transpose(1, 0, 2)


@pytest.fixture(scope="module")
def ranks():
    """One group of 8 gloo ranks runs every case; returns {case: [per-rank
    result]}, and the JAX state the crossing case starts from."""
    inp = _inputs()
    irs, bx = inp["crossing"]
    _, jax_mid = _jax_stream((2, 4), 32, 8, irs, bx[:5])
    xf = inp["xfade"]
    cases = [("fft", "fft_case", ((8, 1), *inp["fft"]))]
    cases += [(("lti", s), "stream_case", (s, 32, 8, *inp["lti"][s])) for s in SHAPES]
    cases += [("tv", "stream_case", ((2, 4), 16, 8, None, *inp["tv"]))]
    rx, rh = inp["repro"]
    rep = (np.repeat(rx[None], 5, 0), np.repeat(rh[None], 5, 0))
    cases += [(f"repro{i}", "stream_case", ((2, 4), 16, 8, None, *rep)) for i in (0, 1)]
    cases += [("serving", "stream_case", (balanced_shape(8), 32, 8, *inp["serving"]))]
    cases += [("collectives", "stream_case", ((2, 4), 32, 8, None, *inp["collectives"]))]
    cases += [("crossing", "stream_case", ((2, 4), 32, 8, None, bx[5:], None, jax_mid))]
    cases += [("roundtrip", "roundtrip_case", ((2, 4), jax_mid))]
    cases += [(("xfade", s), "xfade_case", (s, 32, 8, xf["irs0"], xf["irs_new"], xf["mask"],
                                             xf["x"], 3, 2)) for s in XFADE_SHAPES]
    cases += [(("bad_mesh", s, b), "bad_mesh_case", (s, b))
              for s, b in (((3, 3), "gloo"), ((2, 4), "nccl"))]
    per_rank = run_ranks(8, R.run_cases, cases, timeout=600)
    return {name: [r[name] for r in per_rank] for name, _, _ in cases}, jax_mid


def _assemble(results, key="outs"):
    """A case's global rows from the ranks at tp coordinate 0."""
    parts = sorted((r["rows"].start, r[key]) for r in results if r["coords"]["tp"] == 0)
    return np.concatenate([p for _, p in parts])


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(got, ref, atol=tol * (np.abs(ref).max() + 1e-9), rtol=0)


def test_balanced_shape():
    assert balanced_shape(8) == (2, 4)
    assert balanced_shape(4) == (2, 2)
    assert balanced_shape(7) == (1, 7)
    assert balanced_shape(1) == (1, 1)


def test_make_mesh_defaults_to_the_card():
    """Without arguments make_mesh asks for NCCL on a card: on a machine
    with no card it raises instead of running on the CPU (with one, it
    needs a process group first)."""
    if torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="process group"):
            make_mesh()
    else:
        with pytest.raises(DeviceError):
            make_mesh()


def test_mesh_must_cover_the_world_and_match_the_backend(ranks):
    res, _ = ranks
    assert all("does not cover 8 ranks" in r for r in res[("bad_mesh", (3, 3), "gloo")])
    assert all("runs 'gloo', not 'nccl'" in r for r in res[("bad_mesh", (2, 4), "nccl")])


def test_sharded_fft_matches_local(ranks):
    res, _ = ranks
    x, xi = _inputs()["fft"]
    got = _assemble(res["fft"], "re") + 1j * _assemble(res["fft"], "im")
    ref = np.fft.fft(x + 1j * xi)
    _close(got, ref, 2e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_lti_matches_unsharded(ranks, shape):
    res, _ = ranks
    irs, bx = _inputs()["lti"][shape]
    got = _assemble(res[("lti", shape)])
    jout, _ = _jax_stream(shape, 32, 8, irs, bx)
    _close(got, jout)
    _close(got, _unsharded(32, 8, irs, bx))


@functools.lru_cache(maxsize=None)
def _deployment():
    """The deployment shape on every mesh shape, one group of 8 ranks:
    pts 512, nparts 256 (2^17 taps), batch 8, 2 blocks."""
    rng = np.random.default_rng(12)
    irs = (0.05 * rng.standard_normal((8, 512 * 256))).astype(np.float32)
    bx = rng.standard_normal((2, 8, 512)).astype(np.float32)
    cases = [(s, "stream_case", (s, 512, 256, irs, bx)) for s in SHAPES]
    per_rank = run_ranks(8, R.run_cases, cases, timeout=900)
    return irs, bx, {s: [r[s] for r in per_rank] for s in SHAPES}


@pytest.mark.slow
@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_lti_deployment_shape(shape):
    irs, bx, res = _deployment()
    got = _assemble(res[shape])
    jout, _ = _jax_stream(shape, 512, 256, irs, bx)
    _close(got, jout)
    _close(got, _unsharded(512, 256, irs, bx))


def test_sharded_tv_matches_unsharded(ranks):
    res, _ = ranks
    bx, bh = _inputs()["tv"]
    got = _assemble(res["tv"])
    jout, _ = _jax_stream((2, 4), 16, 8, None, bx, bh)
    _close(got, jout)
    _close(got, _unsharded(16, 8, None, bx, bh))


def test_nparts_must_divide_tp():
    mesh = Mesh(shape={"dp": 2, "tp": 4}, coords={"dp": 0, "tp": 0}, groups={},
                device=torch.device("cpu"), backend="gloo")
    cfg = P.PconvConfig.for_ir_length(32 * 6, 32)   # nparts=6, tp=4
    with pytest.raises(ValueError):
        make_sharded_pconv_step(cfg, mesh)
    with pytest.raises(ValueError):
        make_sharded_pconv_xfade(cfg, mesh)


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_entry(n):
    """The dry run at the deployment shape (pts 512, nparts 256, batch 8)
    on the balanced mesh of n gloo ranks agrees with the unsharded engine,
    and its dist_fft over tp with numpy."""
    got = dryrun_multichip(n, backend="gloo", device="cpu")
    assert got["shape"] == balanced_shape(n)
    assert got["err"] <= 1e-4 * got["scale"]
    assert got["dist_fft_err"] <= 3e-5


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the machine without a card")
def test_dryrun_multichip_defaults_to_the_card():
    """With its defaults the dry run asks for NCCL on the card: without one
    it raises DeviceError before any rank starts, as make_mesh() does."""
    with pytest.raises(DeviceError):
        dryrun_multichip(4)


class _Picked(Exception):
    pass


@pytest.mark.parametrize("cards,n,backend,device,picked", [
    (1, 4, None, "cuda", "gloo"), (4, 4, None, "cuda", "nccl"), (2, 8, None, "cuda", "gloo"),
    (1, 4, "gloo", "cuda", "gloo"), (0, 4, None, "cpu", "gloo"), (8, 4, "gloo", "cpu", "gloo")])
def test_dryrun_multichip_picks_its_backend(monkeypatch, cards, n, backend, device, picked):
    """With no backend named, n ranks on the card take NCCL when there is a
    card a rank, else gloo sharing the cards (the JAX entry point's virtual
    devices); the CPU takes gloo. NCCL named for too few cards stays a
    ValueError."""
    dry = importlib.import_module("opencl_fft_tpu_torch.parallel.dryrun")
    monkeypatch.setattr(dry.torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(dry.torch.cuda, "device_count", lambda: cards)

    def fake_run_ranks(n_, fn, *args, backend, timeout):
        raise _Picked(backend, args[1:])

    monkeypatch.setattr(dry, "run_ranks", fake_run_ranks)
    with pytest.raises(_Picked) as e:
        dry.dryrun_multichip(n, backend=backend, device=device)
    assert e.value.args == (picked, (picked, device))
    if device == "cuda":
        with pytest.raises(ValueError, match="one rank a card"):
            dry.dryrun_multichip(cards + 1, backend="nccl")


def test_dist_serving_demo_runs(ranks):
    """examples/dist_serving_demo.py's cross-check: 8 channels streamed
    through the sharded farm on the balanced mesh, channel 0 against the
    single-device stream (port and JAX) at 3e-5 of max(1, scale)."""
    res, _ = ranks
    irs, bx = _inputs()["serving"]
    got = _assemble(res["serving"])
    cfg = P.PconvConfig.for_ir_length(256, 32)
    _, ref = P.pconv_stream(cfg, P.push_ir(cfg, P.pconv_init(cfg, "cpu"),
                                           torch.from_numpy(irs[0])), torch.from_numpy(bx[:, 0]))
    jcfg = J.PconvConfig.for_ir_length(256, 32)
    _, jref = J.pconv_stream(jcfg, J.push_ir(jcfg, J.pconv_init(jcfg), jnp.asarray(irs[0])),
                             jnp.asarray(bx[:, 0]))
    for r in (ref.numpy(), np.asarray(jref)):
        err = float(np.max(np.abs(got[0] - r)))
        assert err / max(1.0, float(np.max(np.abs(r)))) <= 3e-5


def test_sharded_step_bitwise_reproducible(ranks):
    res, _ = ranks
    assert np.array_equal(_assemble(res["repro0"]), _assemble(res["repro1"]))


@pytest.mark.parametrize("shape", XFADE_SHAPES)
def test_sharded_xfade_blends_and_preserves_untouched(ranks, shape):
    """Swapped channels blend their two exact convolutions (scipy oracle);
    untouched channels match a never-swapped sharded engine to 1e-5 of the
    output scale; after the fade the plain step carries on."""
    res, _ = ranks
    xf = _inputs()["xfade"]
    pts, K, start, swap_ch = 32, 2, 3, 5
    got = _assemble(res[("xfade", shape)])                  # (batch, nblocks, pts)
    unswapped = _assemble(res[("xfade", shape)], "refs")
    nblocks = xf["x"].shape[0]
    scale = np.max(np.abs(unswapped)) + 1e-9
    for ch in range(8):
        if ch != swap_ch:
            np.testing.assert_allclose(got[ch], unswapped[ch], atol=1e-5 * scale, rtol=0)
    xs = xf["x"][:, swap_ch].reshape(-1)
    y_old = sps.fftconvolve(xs, xf["irs0"][swap_ch])[:nblocks * pts]
    y_new = sps.fftconvolve(xs, xf["ir_new"])[:nblocks * pts]
    r = np.zeros(nblocks * pts, np.float32)
    f0, f1 = start * pts, (start + K) * pts
    r[f0:f1] = (np.arange(K * pts) + 1) / np.float32(K * pts)
    r[f1:] = 1.0
    _close(got[swap_ch].reshape(-1), (1 - r) * y_old + r * y_new)
    # the JAX sharded crossfade on the same schedule
    mesh = jax_mesh(shape)
    cfg = J.PconvConfig.for_ir_length(pts * 8, pts)
    sh = JS.state_shardings(mesh)
    dp_rows = NamedSharding(mesh, P_("dp", None))
    st = {k: jax.device_put(v, sh[k]) for k, v in JS.sharded_pconv_init(cfg, 8).items()}
    st = JS.sharded_push_ir(cfg, mesh, st, jax.device_put(jnp.asarray(xf["irs0"]), dp_rows))
    step = JS.make_sharded_pconv_step(cfg, mesh, tv=False)
    begin, step_xf = JS.make_sharded_pconv_xfade(cfg, mesh)
    jouts, jxf = [], None
    for i in range(nblocks):
        if i == start:
            jxf = begin(st, jax.device_put(jnp.asarray(xf["irs_new"]), dp_rows),
                        jax.device_put(jnp.asarray(xf["mask"]), NamedSharding(mesh, P_("dp"))))
        if jxf is not None and i - start < K:
            ramp = (np.arange(pts, dtype=np.float32) + 1 + (i - start) * pts) / np.float32(K * pts)
            jxf, o = step_xf(jxf, xf["x"][i], jnp.asarray(ramp))
            if i - start == K - 1:
                st, jxf = {k: jxf[k] for k in st}, None
        else:
            st, o = step(st, xf["x"][i])
        jouts.append(np.asarray(o))
    _close(got, np.stack(jouts, 1))


def test_sharded_step_collective_structure(ranks):
    """The sharded step's only communication is one all_reduce a block, of
    the (2, batch/dp, bins) accumulators: O(bins), never O(nparts x bins)
    (the JAX test reads the same from the lowered module)."""
    res, _ = ranks
    batch, dp, bins, nblocks = 8, 2, 32, 3
    for r in res["collectives"]:
        assert r["all_reduces"] == nblocks
        assert r["all_reduce_elements"] == nblocks * 2 * (batch // dp) * bins
    assert _assemble(res["collectives"]).shape == (batch, nblocks, 32)


def test_sharded_state_crosses_from_jax(ranks):
    """A JAX sharded state (global numpy) continues on the port's ranks as
    on the JAX engine; the gathered state matches JAX's."""
    res, jax_mid = ranks
    irs, bx = _inputs()["crossing"]
    got = _assemble(res["crossing"])
    jout, jend = _jax_stream((2, 4), 32, 8, None, bx[5:], state=jax_mid)
    _close(got, jout)
    for r in res["crossing"]:
        for name in ("spec_x_re", "spec_x_im", "spec_h_re", "spec_h_im", "tail"):
            _close(r["state"][name], jend[name], 1e-5)
        assert (int(r["state"]["wp"]), int(r["state"]["wp2"])) == \
            (int(jend["wp"]), int(jend["wp2"]))


def test_shard_gather_roundtrip(ranks):
    res, jax_mid = ranks
    for r in res["roundtrip"]:
        assert set(r) == set(jax_mid)
        for name, a in jax_mid.items():
            assert np.array_equal(r[name], a), name
