"""The matrix scan entry (``ops/cuda/streamstep.py``
``stream_steps_fused_matrix``) and the route of ``MatrixConvolver.stream``
through it.

On the CPU the wrapper runs its plain twin: against the n_out n_in pairs'
batched scan summed over the inputs (the route ``MatrixConvolver.stream``
took before it, and still takes for configs the kernels do not take),
against the JAX package's ``MatrixConvolver`` and float64 scipy, with
nparts past the tiled MAC's first stage; the layout switches between the
compact state of the matrix scan and the pair state of ``step`` /
``set_ir`` / ``push_ir``, chained; the configs that keep the pair route.
On a card (``cuda`` marker, skipped here) the kernel against the twin at
16 x 16 and odd shapes, and one launch of the entry and none of the
batched entry a ``stream`` call.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import signal as sps

from opencl_fft_tpu_torch import models as M
from opencl_fft_tpu_torch.ops import pconv as P
from opencl_fft_tpu_torch.ops.cuda import streamstep as S
from opencl_fft_tpu_torch.utils import profiling as PF

torch.set_num_threads(1)

CPU = "cpu"
F32 = 4
MATRICES = [(1, 2), (2, 2), (3, 2), (4, 4)]    # (n_in, n_out)
# nparts past the LTI MAC's stage (2 * MAC_STAGE partitions), its last
# stage ragged
PTS, NPARTS = 8, 2 * S.MAC_STAGE + 3


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _data(n_in, n_out, nblocks, pts=PTS, nparts=NPARTS, seed=0):
    """(irs (n_out, n_in, cvs), blocks (nblocks, n_in, pts)), float32."""
    rng = np.random.default_rng(seed)
    irs = rng.standard_normal((n_out, n_in, pts * nparts)).astype(np.float32)
    x = rng.standard_normal((nblocks, n_in, pts)).astype(np.float32)
    return irs, x


def _matrix(n_in, n_out, irs, pairs=False, pts=PTS, nparts=NPARTS, **kw):
    """A MatrixConvolver on the CPU with ``irs`` pushed; ``pairs``: held to
    the pair route (its ``stream`` tiles the input to the n_out n_in
    pairs' batched scan and sums their outputs)."""
    m = M.MatrixConvolver(P.PconvConfig(pts=pts, nparts=nparts, **kw), n_in, n_out, device=CPU)
    if pairs:
        m._scannable = lambda: False
    m.push_ir(irs)
    return m


def _scipy(x, irs):
    """float64 out[o] = sum_i x_i * ir[o, i], (nblocks, n_out, pts)."""
    nb, n_in, pts = x.shape
    xs = x.transpose(1, 0, 2).reshape(n_in, -1).astype(np.float64)
    y = np.stack([sum(sps.fftconvolve(xs[i], irs[o, i].astype(np.float64))[:nb * pts]
                      for i in range(n_in)) for o in range(irs.shape[0])])
    return y.reshape(irs.shape[0], nb, pts).transpose(1, 0, 2)


# -- the twin -------------------------------------------------------------------

@pytest.mark.parametrize("n_in, n_out", MATRICES)
def test_twin_is_the_pairs_scan_summed_over_inputs(n_in, n_out):
    """The wrapper's twin against the batched twin of the n_out n_in pairs
    (input tiled, windows tiled, tail o in pair (o, 0)) summed over the
    inputs: outputs and final tails within float32 rounding, final windows
    equal to the pairs' (every output's copy of an input's is the same)."""
    nb = 2 * S.MAC_STAGE + 5
    gen = torch.Generator().manual_seed(n_in * 10 + n_out)

    def r(*shape):
        return torch.randn(shape, generator=gen)

    blocks, w0 = r(nb, n_in, PTS), (r(n_in, NPARTS, PTS), r(n_in, NPARTS, PTS))
    h = (r(n_out * n_in, NPARTS, PTS), r(n_out * n_in, NPARTS, PTS))
    tails = r(n_out, PTS)
    outs, (wfr, wfi), tf = S.stream_steps_fused_matrix(blocks, w0, h, 2.0, tails, PTS)
    assert outs.shape == (nb, n_out, PTS) and wfr.shape == (n_in, NPARTS, PTS)
    assert tf.shape == (n_out, PTS)
    tails_p = torch.zeros((n_out, n_in, PTS))
    tails_p[:, 0] = tails
    po, (pr, pi), ptf = S.stream_steps_fused_batched(
        blocks.repeat(1, n_out, 1), tuple(w.repeat(n_out, 1, 1) for w in w0), h, 2.0,
        tails_p.reshape(-1, PTS), PTS)
    assert _rel(outs, po.reshape(nb, n_out, n_in, PTS).sum(2)) < 2e-6
    assert _rel(tf, ptf.reshape(n_out, n_in, PTS).sum(1)) < 2e-6
    assert torch.equal(wfr, pr[:n_in]) and torch.equal(wfi, pi[:n_in])


def test_twin_checks_its_shapes():
    b, w, h, t = torch.zeros(3, 2, 8), torch.zeros(2, 4, 8), torch.zeros(6, 4, 8), \
        torch.zeros(3, 8)
    S.stream_steps_fused_matrix(b, (w, w), (h, h), 2.0, t, 8)
    with pytest.raises(ValueError, match="h planes"):
        S.stream_steps_fused_matrix(b, (w, w), (h[:5], h[:5]), 2.0, t, 8)
    with pytest.raises(ValueError, match="tails"):
        S.stream_steps_fused_matrix(b, (w, w), (h, h), 2.0, t[:2], 8)
    with pytest.raises(ValueError, match="w0 re"):
        S.stream_steps_fused_matrix(b, (w[:1], w), (h, h), 2.0, t, 8)
    with pytest.raises(ValueError, match="power-of-two"):
        S.stream_steps_fused_matrix(b, (w, w), (h, h), 2.0, t, 6)


@pytest.mark.parametrize("n_in, n_out", MATRICES)
def test_stream_against_the_pair_route_jax_and_scipy(n_in, n_out):
    """Two chained ``stream`` calls from a zero history on the matrix scan
    against the same calls on the pair route, the JAX MatrixConvolver and
    float64 scipy."""
    from opencl_fft_tpu.models import convolver as JM
    from opencl_fft_tpu.ops import pconv as J

    nb = NPARTS + 5
    irs, x = _data(n_in, n_out, nb, seed=n_in * 10 + n_out)
    cut = NPARTS - 2
    m, mp = _matrix(n_in, n_out, irs), _matrix(n_in, n_out, irs, pairs=True)
    got = torch.cat([m.stream(x[:cut]), m.stream(x[cut:])]).numpy()
    pairs = torch.cat([mp.stream(x[:cut]), mp.stream(x[cut:])]).numpy()
    assert m._compact is not None and mp._compact is None
    jm = JM.MatrixConvolver(J.PconvConfig.for_ir_length(PTS * NPARTS, PTS), n_in, n_out)
    jm.push_ir(irs)
    jax = np.concatenate([np.asarray(jm.stream(x[:cut])), np.asarray(jm.stream(x[cut:]))])
    assert _rel(got, pairs) < 2e-6
    assert _rel(got, jax) < 2e-5
    assert _rel(got, _scipy(x, irs)) < 2e-5


# -- the layouts ------------------------------------------------------------------

def test_layouts_chain_through_every_entry():
    """stream -> step -> stream -> set_ir (a crossfade) -> steps through
    the fade -> stream -> push_ir -> stream, against the same calls on the
    pair route: each output within float32 rounding, the state converted at
    each switch (compact after ``stream``, pairs after the others)."""
    n_in, n_out, fade = 3, 2, 3
    irs, x = _data(n_in, n_out, 2 * NPARTS + 30, seed=7)
    new, _ = _data(n_in, n_out, 1, seed=8)
    m, mp = _matrix(n_in, n_out, irs), _matrix(n_in, n_out, irs, pairs=True)
    at = 0

    def both(call):
        ys = [call(eng) for eng in (m, mp)]
        assert _rel(ys[0], ys[1]) < 5e-6

    def stream(n):
        nonlocal at
        both(lambda e: e.stream(x[at:at + n]))
        assert m._compact is not None
        at += n

    def step():
        nonlocal at
        both(lambda e: e.step(x[at]))
        assert m._compact is None
        at += 1

    stream(NPARTS + 2)
    step()
    stream(9)
    for e in (m, mp):
        e.set_ir(new[0, :1], entries=[(1, 0)], fade_blocks=fade)
    assert m._compact is None
    with pytest.raises(RuntimeError, match="crossfade"):
        m.stream(x[at:at + 2])
    for _ in range(fade):
        step()
    stream(7)
    for e in (m, mp):
        e.push_ir(new)
    assert m._compact is None
    stream(NPARTS)
    step()
    assert at <= len(x)


def test_compact_state_converts_exactly():
    """Pairs -> compact -> pairs after steps: the rings the pair (0, i)
    ones, each tail the sum of its pairs', the pair state left with its IR
    planes alone; back, the rings copied to every output and each pair's
    tail rebuilt from its ring and IR, bit-equal to the tail the steps left
    (on the CPU the step's MAC is the rebuild's)."""
    n_in, n_out = 2, 3
    irs, x = _data(n_in, n_out, 12, seed=9)
    m = _matrix(n_in, n_out, irs)
    for b in x[:4]:
        m.step(b)
    pair = m._conv.state
    compact = m._to_compact()
    assert m._compact is compact and m._to_compact() is compact
    assert torch.equal(compact.spec_x_re, pair.spec_x_re[:n_in])
    assert torch.equal(compact.tail, pair.tail.reshape(n_out, n_in, -1).sum(1))
    held = m._conv.state
    assert held.spec_x_re is None and held.spec_x_im is None and held.tail is None
    assert held.spec_h_re is pair.spec_h_re and held.spec_h_im is pair.spec_h_im
    m._to_pairs()
    back = m._conv.state
    assert m._compact is None and back.wp == pair.wp
    for o in range(n_out):
        assert torch.equal(back.spec_x_re[o * n_in:(o + 1) * n_in], compact.spec_x_re)
    assert torch.equal(back.tail, pair.tail)


def test_an_empty_stream_keeps_the_layout():
    n_in, n_out = 2, 2
    irs, x = _data(n_in, n_out, 3, seed=11)
    m = _matrix(n_in, n_out, irs)
    m.step(x[0])
    y = m.stream(x[:0])
    assert y.shape == (0, n_out, PTS) and m._compact is None


def test_matrix_group_is_the_kernels():
    """The twin sums inputs in the kernel's groups: ``MATRIX_GROUP`` is the
    constant of ``csrc/streamstep.cu``."""
    src = (Path(S.__file__).parents[2] / "csrc" / "streamstep.cu").read_text()
    assert re.findall(r"constexpr int MATRIX_GROUP = (\d+);", src) == [str(S.MATRIX_GROUP)]


@pytest.mark.parametrize("case", ["bf16", "f64"])
def test_other_configs_keep_the_pair_route(case):
    """bf16 rings and float64 stream on the pair state: rings in its dtype
    (the dtype check of the models' tests), the
    fan spans and bytes recorded, no compact state; outputs as the float32
    matrix scan's within the dtype's rounding."""
    n_in, n_out, nb = 2, 2, 20
    irs, x = _data(n_in, n_out, nb, pts=16, nparts=4, seed=10)
    kw = {"bf16": dict(ring_dtype="bf16"), "f64": dict(dtype="f64")}[case]
    m = _matrix(n_in, n_out, irs, pts=16, nparts=4, **kw)
    ref = _matrix(n_in, n_out, irs, pts=16, nparts=4).stream(x)
    PF.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = m.stream(x)
    names = {s.name for s in PF.spans()}
    fan = PF.counters()["matrix.fan_bytes"]
    PF.reset()
    assert m._compact is None and {"fanout", "fanin"} <= names
    item = 8 if case == "f64" else F32
    assert fan == 2 * n_out * n_in * nb * 16 * item
    if case == "bf16":
        assert m._conv.state.spec_x_re.dtype == torch.bfloat16
    assert _rel(got, ref) < (5e-3 if case == "bf16" else 2e-6)


# -- on a card --------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the matrix scan kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(n_in, n_out, nb, pts, nparts, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def r(*shape, s=1.0):
        return (s * torch.randn(shape, generator=gen)).to(dev)

    return (r(nb, n_in, pts, s=0.1), (r(n_in, nparts, pts), r(n_in, nparts, pts)),
            (r(n_out * n_in, nparts, pts, s=0.05), r(n_out * n_in, nparts, pts, s=0.05)),
            r(n_out, pts))


@pytest.mark.cuda
@pytest.mark.parametrize("n_in, n_out, pts, nparts, nb, tt", [
    # the Ambisonic matrix at the cell's pts and blocks (a shorter IR, its
    # last MAC stage ragged): the TILE_TT_MAX MAC the cell runs
    (16, 16, 512, 2 * S.MAC_STAGE + 3, 470, S.TILE_TT_MAX),
    (16, 16, 64, 2 * S.MAC_STAGE + 3, 150, S.MAC_TT),    # too few tiles for TILE_TT_MAX
    (3, 5, 16, 7, 9, S.MAC_TT), (5, 2, 512, 33, 37, S.MAC_TT), (1, 1, 2, 1, 3, S.MAC_TT),
    (2, 3, 4096, 5, 6, S.MAC_TT), (2, 2, 1 << 15, 2, 3, S.MAC_TT)])
def test_cuda_kernel_against_its_twin(cuda_device, n_in, n_out, pts, nparts, nb, tt):
    """The kernel against the twin on the same card tensors, at the MAC
    width ``matrix_plan`` gives the card: outputs, final windows and tails;
    bit-equal on a second launch."""
    sms = S._build.sm_count(cuda_device.index or 0)
    assert S.matrix_plan(n_in, n_out, nb, pts, nparts, sms)[3] == tt
    args = _inputs(n_in, n_out, nb, pts, nparts, cuda_device, seed=n_in + pts)
    got = S.stream_steps_fused_matrix(*args[:3], 2.0, args[3], pts)
    again = S.stream_steps_fused_matrix(*args[:3], 2.0, args[3], pts)
    want = S.stream_steps_fused_matrix_plain(*args[:3], 2.0, args[3], pts)
    torch.cuda.synchronize()
    assert _rel(got[0].cpu(), want[0].cpu()) < 2e-5
    assert _rel(got[2].cpu(), want[2].cpu()) < 2e-5
    assert _rel(got[1][0].cpu(), want[1][0].cpu()) < 2e-5
    assert torch.equal(got[0], again[0]) and torch.equal(got[2], again[2])


@pytest.mark.cuda
def test_cuda_stream_launches_the_matrix_entry_once(cuda_device):
    """``MatrixConvolver(16, 16).stream`` on a card: one matrix-entry
    launch and no batched-scan launch a call; its outputs as the pair
    route's within float32 rounding; ``step`` after it as the pair
    route's."""
    n, pts, nparts, nb = 16, 64, 2 * S.MAC_STAGE + 3, 150
    rng = np.random.default_rng(3)
    irs = (0.05 * rng.standard_normal((n, n, pts * nparts))).astype(np.float32)
    x = torch.from_numpy((0.1 * rng.standard_normal((2 * nb + 1, n, pts))).astype(
        np.float32)).to(cuda_device)
    cfg = P.PconvConfig(pts=pts, nparts=nparts)
    m = M.MatrixConvolver(cfg, n, n, device=cuda_device)
    mp = M.MatrixConvolver(cfg, n, n, device=cuda_device)
    mp._scannable = lambda: False
    for e in (m, mp):
        e.push_ir(irs)
    for call in (slice(0, nb), slice(nb, 2 * nb)):
        before = (S.MATRIX_LAUNCHES, S.BATCHED_LAUNCHES)
        y = m.stream(x[call])
        torch.cuda.synchronize()
        assert (S.MATRIX_LAUNCHES - before[0], S.BATCHED_LAUNCHES - before[1]) == (1, 0)
        assert _rel(y.cpu(), mp.stream(x[call]).cpu()) < 2e-6
    assert _rel(m.step(x[-1]).cpu(), mp.step(x[-1]).cpu()) < 2e-6
