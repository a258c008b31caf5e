"""The per-block step above pts 2048 as one replayed CUDA graph
(``ops/pconv.StepGraph``) and the ring pointer that #11 reads from device
memory (``block_mac_unpack(..., rp_at)``).

On the CPU the graph's body runs eagerly, the same ops on the same
tensors, and is held bit-equal to ``pconv_step{,_tv}``: alone, through
``Clpconv`` (a ``push_ir`` mid-stream, a crossfade, the TV form), the
processors (a frozen TV operand, ``set_ir``) and the zero-latency engine's
terminal segment. The graph runs the card's route of the per-block
functions (``block_mac_unpack``, its twin on CPU tensors), so the cases
patch that route in (``graph_route``). On a card (``cuda`` marker) the
kernel reading rp from device memory, and the replays, against the eager
steps bit for bit. No JAX here: the card's tests run in this file."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from audiobench import catalog, program
from opencl_fft_tpu_torch import api
from opencl_fft_tpu_torch import stream as tstream
from opencl_fft_tpu_torch.models import ZeroLatencyConvolver
from opencl_fft_tpu_torch.models import lowlatency as LL
from opencl_fft_tpu_torch.ops import pconv as P
from opencl_fft_tpu_torch.ops.cuda import blockstep as BS
from opencl_fft_tpu_torch.utils import profiling as PF


@pytest.fixture(autouse=True)
def _fresh():
    PF.reset()
    yield
    PF.reset()


@pytest.fixture
def graph_route(monkeypatch):
    """The card's route above pts 2048 on CPU tensors, where an engine that
    owns its state takes its step graph (run eagerly on the CPU)."""
    monkeypatch.setattr(P, "_mac_unpack_kernel", lambda cfg, device: True)


def _rng(seed):
    return np.random.default_rng(seed)


def _live(cfg, seed=1, device="cpu"):
    ir = (0.3 * _rng(seed).standard_normal(cfg.cvs)).astype(np.float32)
    return P.push_ir(cfg, P.pconv_init(cfg, device), torch.from_numpy(ir).to(device))


def _assert_states_equal(got, want, what):
    for k in P._PLANES:
        assert torch.equal(getattr(got, k), getattr(want, k)), f"{what}: {k}"
    assert (got.wp, got.wp2) == (want.wp, want.wp2), what


def _eager_beside(eng: api.Clpconv) -> api.Clpconv:
    """``eng`` with its step graphs off: every block by the functional
    steps."""
    eng._replay = eng._eager
    return eng


# -- the CPU: the body in place of the graph -----------------------------------

@pytest.mark.parametrize("tv", [False, True], ids=["lti", "tv"])
@pytest.mark.parametrize("pts,nparts", [(32, 5), (16, 2), (16, 1), (64, 3), (8, 7), (32, 2)])
def test_body_is_the_eager_step_bit_for_bit(graph_route, tv, pts, nparts):
    """Over 2 nparts + 3 firings (both pointers wrap), each output, ring,
    tail and int pointer of the body equals ``pconv_step{,_tv}``'s; the
    planes are the same tensors at every firing (written in place)."""
    cfg = P.PconvConfig(pts=pts, nparts=nparts)
    rng = _rng(3 + tv)
    ref = cur = _live(cfg)
    graph = P.StepGraph(cfg, "cpu", tv)
    first = None
    for i in range(2 * nparts + 3):
        x = rng.standard_normal((2, pts)).astype(np.float32)
        graph.x_np[:] = x[:1 + tv]
        if tv:
            ref, want = P.pconv_step_tv(cfg, ref, *map(torch.from_numpy, x))
        else:
            ref, want = P.pconv_step(cfg, ref, torch.from_numpy(x[0]))
        cur = graph.step(cur)
        np.testing.assert_array_equal(graph.output(), want.numpy(), err_msg=f"firing {i}")
        _assert_states_equal(cur, ref, f"firing {i}")
        first = first or cur
        assert all(getattr(cur, k) is getattr(first, k) for k in P._PLANES)
    assert graph.graph is None and graph.published is cur


@pytest.mark.parametrize("tv", [False, True], ids=["lti", "tv"])
def test_a_state_from_outside_is_adopted_and_left_alone(tv):
    """A state not the one the graph published is copied into its planes;
    the given state's tensors are not written."""
    cfg = P.PconvConfig(pts=16, nparts=3)
    graph = P.StepGraph(cfg, "cpu", tv)
    given = _live(cfg)
    kept = {k: getattr(given, k).clone() for k in P._PLANES}
    graph.x_np[:] = 1.0
    after = graph.step(given)
    assert all(torch.equal(getattr(given, k), v) for k, v in kept.items())
    assert all(getattr(after, k) is not getattr(given, k) for k in P._PLANES)
    with pytest.raises(ValueError, match="its own shapes"):
        graph.step(P.pconv_init(P.PconvConfig(pts=16, nparts=4), "cpu"))


@pytest.mark.parametrize("rp,held", [(0, 2), (2, 0), (4, 4), (1, 3)])
def test_the_twin_reads_rp_where_the_kernel_would(rp, held):
    """``rp_at`` given, the twin takes the row it holds (the int is only
    checked), as the kernel reads it when it runs."""
    rng = _rng(rp)
    x2 = tuple(torch.from_numpy(rng.standard_normal((10, 12)).astype(np.float32))
               for _ in range(2))
    h = tuple(torch.from_numpy(rng.standard_normal((5, 12)).astype(np.float32))
              for _ in range(2))
    got = BS.block_mac_unpack(x2, h, rp, 2.0, torch.tensor([held], dtype=torch.int32))
    want = BS.block_mac_unpack(x2, h, held, 2.0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    for bad in (torch.tensor([held]), torch.tensor([held, held], dtype=torch.int32)):
        with pytest.raises(ValueError, match="rp_at"):
            BS.block_mac_unpack(x2, h, rp, 2.0, bad)


def _blocks(n, pts, seed):
    return _rng(seed).standard_normal((n, 2, pts)).astype(np.float32)


@pytest.mark.parametrize("case", ["lti", "push_ir", "xfade", "tv"])
def test_clpconv_on_its_graph_is_the_functional_engine(graph_route, case):
    """``Clpconv`` on its step graph against the same engine by the
    functional steps, block by block over 2 nparts + 3 blocks and more:
    outputs, rings, tails and pointers; a ``push_ir`` mid-stream and a
    crossfade (eager while it runs) are adopted by the graph after them,
    which keeps writing the same planes."""
    pts, nparts = 16, 4
    ir = (0.3 * _rng(7).standard_normal(pts * nparts)).astype(np.float32)
    new_ir = (0.3 * _rng(8).standard_normal(pts * nparts)).astype(np.float32)
    a, b = (api.Clpconv(0, pts * nparts, pts, device="cpu") for _ in range(2))
    _eager_beside(b)
    for eng in (a, b):
        eng.push_ir(ir)
    tv = case == "tv"
    ya, yb = np.empty(pts, np.float32), np.empty(pts, np.float32)
    planes = None
    for i, x in enumerate(_blocks(3 * nparts + 5, pts, 11)):
        if i == nparts + 1 and case != "lti" and not tv:
            for eng in (a, b):
                eng.push_ir(new_ir) if case == "push_ir" else eng.push_ir_xfade(new_ir, 3)
        args = (x[0], x[1]) if tv else (x[0],)
        on_graph = a._xf is None
        a.convolution(ya, *args)
        b.convolution(yb, *args)
        np.testing.assert_array_equal(ya, yb, err_msg=f"block {i}")
        if on_graph:
            _assert_states_equal(a.state, b.state, f"block {i}")
            assert a.state is a._graphs[tv].published
            mine = [getattr(a.state, k) for k in P._PLANES]
            planes = planes or mine
            assert all(m is p for m, p in zip(mine, planes)), f"block {i}"
    assert list(a._graphs) == [tv] and not b._graphs


def test_a_clpconv_of_both_forms_keeps_one_graph_each(graph_route):
    """LTI and TV blocks in turn: each form's graph adopts the state the
    other published."""
    pts, nparts = 16, 3
    a, b = (api.Clpconv(0, pts * nparts, pts, device="cpu") for _ in range(2))
    _eager_beside(b)
    ya, yb = np.empty(pts, np.float32), np.empty(pts, np.float32)
    for i, x in enumerate(_blocks(2 * nparts + 3, pts, 12)):
        args = (x[0], x[1]) if i % 3 else (x[0],)
        a.convolution(ya, *args)
        b.convolution(yb, *args)
        np.testing.assert_array_equal(ya, yb, err_msg=f"block {i}")
        _assert_states_equal(a.state, b.state, f"block {i}")
    assert sorted(a._graphs) == [False, True]


@pytest.mark.parametrize("tv", [False, True], ids=["clconv", "cltvconv"])
def test_processors_on_the_graph_are_the_functional_ones(graph_route, tv):
    """64-sample callbacks at pts 256 through the processors, a TV operand
    frozen and thawed, an LTI ``set_ir`` faded and then instant: the
    outputs of the processor on its graph equal those of one on the
    functional steps."""
    pts, taps, k = 256, 256 * 3, 64
    if tv:
        a, b = (tstream.CltvconvProcessor(pts, taps, device="cpu") for _ in range(2))
    else:
        ir = (0.3 * _rng(4).standard_normal(taps)).astype(np.float32)
        a, b = (tstream.ClconvProcessor(ir, pts, device="cpu") for _ in range(2))
    _eager_beside(b._engine)
    x = (0.5 * _rng(5).standard_normal((2, 40 * pts))).astype(np.float32)
    swap = (0.3 * _rng(6).standard_normal(taps)).astype(np.float32)
    for i in range(x.shape[1] // k):
        blk = x[:, i * k:(i + 1) * k]
        if tv:
            frozen = 8 <= i < 24 or 30 <= i < 33
            ya = a.process(blk[0], blk[1], freeze2=not frozen, freeze1=i % 20 != 5)
            yb = b.process(blk[0], blk[1], freeze2=not frozen, freeze1=i % 20 != 5)
        else:
            if i in (10, 60):
                for p in (a, b):
                    p.set_ir(swap if i == 10 else x[1, :taps], fade_blocks=2 if i == 10 else 0)
            ya, yb = a.process(blk[0]), b.process(blk[0])
        np.testing.assert_array_equal(ya, yb, err_msg=f"callback {i}")
    assert a._engine._graphs[tv].published is a._engine.state


def _user_scope():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.mark.parametrize("tv", [False, True])
def test_graph_firings_count_and_nest_as_the_eager_ones(graph_route, tv):
    """Each firing on the graph is a ``fire`` request holding ``upload``,
    ``step`` and ``download``; it counts ``step.blocks``, no clone bytes,
    and ``step.replays`` (0 here: the body runs eagerly)."""
    pts = 64
    proc = (tstream.CltvconvProcessor(pts, 4 * pts, device="cpu") if tv else
            tstream.ClconvProcessor(np.ones(4 * pts, np.float32), pts, device="cpu"))
    x = _rng(2).standard_normal(20 * pts).astype(np.float32)
    calls = 3 * (pts // 16) + 1
    with _user_scope():
        for i in range(calls):
            blk = x[i * 16:(i + 1) * 16]
            proc.process(blk, blk[::-1]) if tv else proc.process(blk)
    fired = calls // (pts // 16)
    c = PF.counters()
    assert (c["step.blocks"], c["step.replays"], c["step.ring_clone_bytes"]) == (fired, 0, 0)
    sp = PF.spans()
    fires = [s for s in sp if s.parent is None]
    assert [s.name for s in fires] == ["fire"] * fired
    for f in fires:
        kids = sorted((s for s in sp if s.request == f.request and s.parent is not None),
                      key=lambda s: s.start_ns)
        assert [(s.name, s.parent) for s in kids] == [("upload", "fire"), ("step", "fire"),
                                                      ("download", "fire")]


def _zl_blocks(n, seed=9):
    return _rng(seed).standard_normal((n, 64)).astype(np.float32)


def test_zero_latency_terminal_on_a_step_graph(graph_route):
    """The zero-latency path's terminal segment (15 partitions) on its step
    graph, the phases' bodies run eagerly: over 4 cycles, through a reset
    and a state assigned from numpy, the outputs equal the eager ``_step``'s
    bit for bit, and the terminal's engine is the graph's."""
    from opencl_fft_tpu_torch import interop

    ir = (_rng(5).standard_normal(1 << 13) * np.exp(-np.arange(1 << 13) / 2048)
          ).astype(np.float32)
    a = ZeroLatencyConvolver(ir, block=64, pmax=512, device="cpu")
    a._phases = LL._Phases(a, capture=False)
    b = ZeroLatencyConvolver(ir, block=64, pmax=512, device="cpu")
    P_ = a._phases.period
    assert a.segments[-1].nparts > 1 and a._phases.terminal == len(a.segments) - 1
    for t, x in enumerate(_zl_blocks(4 * P_)):
        if t == 2 * P_ + 3:
            a.reset()
            b.reset()
        elif t == 3 * P_ + 5:
            a.state = interop.zl_state_from_numpy(interop.zl_state_to_numpy(b.state), "cpu")
        np.testing.assert_array_equal(a.process(x), b.process(x), err_msg=f"callback {t}")
        if t >= P_ and a.state.t % P_ == 0:           # the terminal fired on the path
            assert a.state.segs[-1].eng is a._phases.term_graph.published, f"callback {t}"
            _assert_states_equal(a.state.segs[-1].eng, b.state.segs[-1].eng, f"callback {t}")


# -- the reader of the replays' share ------------------------------------------

REPO = Path(__file__).resolve().parents[1]
READER = "step_replay_pct.opcode"


@pytest.mark.parametrize("counts,want", [
    ({"step.blocks": 200, "step.replays": 199}, 99.5),
    ({"step.blocks": 200, "step.replays": 0}, 0.0),
    ({"step.blocks": 200, "step.ring_clone_bytes": 10}, None),
    ({"step.replays": 0}, None),
    ({}, None),
    (None, None)])
def test_replay_share_reader(monkeypatch, counts, want):
    """100 x ``step.replays`` / ``step.blocks``; nothing where the program
    counts no ``step.replays`` (no step graph) or no step."""
    if counts is None:
        monkeypatch.setattr(program, "_profiling", lambda: None)
    else:
        monkeypatch.setattr(program, "counters", lambda: counts)
    got = catalog.reader(REPO, READER)({"counters": {}, "untraced": {}})
    assert got == (pytest.approx(want) if want is not None else None)


def test_replay_share_is_a_metric_of_the_opcode_cell():
    (m,) = [m for m in catalog.benchmark(REPO)["per_layer"] if m["name"] == READER]
    assert m["workloads"] == ["tv2p22_csound_ksmps64"] and m["moves"] == "audio_s_per_s.opcode"
    assert (m["layer"], m["unit"], m["better"], m["source"]) == (
        "entry", "%", "higher", "program_counter")


# -- the card ------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the MAC kernel and CUDA graphs have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("nparts,bins", [(255, 4096), (512, 8192)])
def test_card_mac_reads_rp_from_device_memory(nparts, bins):
    """#11 with rp read from device memory equals the int-rp launch bit for
    bit (the int it is given then another row's)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(nparts)
    x2 = tuple(torch.randn(2 * nparts, bins, device=dev, generator=g) for _ in range(2))
    h = tuple(torch.randn(nparts, bins, device=dev, generator=g) for _ in range(2))
    for rp in (0, 1, nparts // 3, nparts - 1):
        want = BS.block_mac_unpack(x2, h, rp, 2.0)
        at = torch.tensor([rp], dtype=torch.int32, device=dev)
        got = BS.block_mac_unpack(x2, h, (rp + 1) % nparts, 2.0, at)
        assert all(torch.equal(a, w) for a, w in zip(got, want)), f"rp {rp}"


@pytest.mark.cuda
@pytest.mark.parametrize("tv", [False, True], ids=["lti", "tv"])
@pytest.mark.parametrize("pts,nparts", [(4096, 5), (8192, 9)])
def test_card_replays_equal_the_eager_steps(tv, pts, nparts):
    """``Clpconv`` on its graph against the same engine by the functional
    steps over 2 nparts + 3 blocks, bit for bit (outputs, rings, tails,
    pointers); every firing after the first is a replay (``step.replays``),
    none clones a ring."""
    dev = _card()
    ir = (0.3 * _rng(pts).standard_normal(pts * nparts)).astype(np.float32)
    a, b = (api.Clpconv(0, pts * nparts, pts, device=dev) for _ in range(2))
    _eager_beside(b)
    for eng in (a, b):
        eng.push_ir(ir)
    ya, yb = np.empty(pts, np.float32), np.empty(pts, np.float32)
    n = 2 * nparts + 3
    for i, x in enumerate(_blocks(n, pts, 13)):
        args = (x[0], x[1]) if tv else (x[0],)
        with PF.request("fire", True):
            a.convolution(ya, *args)
        b.convolution(yb, *args)
        np.testing.assert_array_equal(ya, yb, err_msg=f"block {i}")
    _assert_states_equal(a.state, b.state, "after the blocks")
    c = PF.counters()
    assert (c["step.blocks"], c["step.replays"], c["step.ring_clone_bytes"]) == (n, n - 1, 0)
    assert a._graphs[tv].graph is not None and a._graphs[tv].failed is None


@pytest.mark.cuda
def test_card_a_failed_capture_leaves_the_eager_body_and_says_so_once(monkeypatch):
    """A body that the capture refuses (a host sync): the graph goes off
    for good, says why once, and the body serves every block eagerly with
    the same answers; random draws on the card work after it."""
    dev = _card()
    pts, nparts = 4096, 3
    said = []
    a = api.Clpconv(0, pts * nparts, pts, errs=lambda msg, ud: said.append(msg), device=dev)
    b = _eager_beside(api.Clpconv(0, pts * nparts, pts, device=dev))
    ir = (0.3 * _rng(1).standard_normal(pts * nparts)).astype(np.float32)
    for eng in (a, b):
        eng.push_ir(ir)
    ya, yb = np.empty(pts, np.float32), np.empty(pts, np.float32)
    for i, x in enumerate(_blocks(2 * nparts + 3, pts, 14)):
        if i == 0:
            a.convolution(ya, x[0])
            graph = a._graphs[False]
            real = graph._body

            def body(rp):
                real(rp)
                torch.cuda.synchronize()

            monkeypatch.setattr(graph, "_body", body)
        else:
            a.convolution(ya, x[0])
        b.convolution(yb, x[0])
        np.testing.assert_array_equal(ya, yb, err_msg=f"block {i}")
    assert graph.failed and graph.graph is None
    assert len([m for m in said if "step graph off" in m]) == 1
    assert torch.randn(4, device=dev).isfinite().all()      # the generator is settled
