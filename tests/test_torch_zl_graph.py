"""The zero-latency engine's graph path (``models/lowlatency._Phases``): one
captured CUDA graph a cadence phase on a card, the terminal segment fired
after the replay (above pts 2048 by its own step graph). On the CPU the
phases' bodies run eagerly in place of their graphs (``capture=False``),
the same ops on the same tensors, and are held bit-equal to the functional
``_step`` through a ``reset`` and a state assigned from ``interop``; on a
card (``cuda`` marker) the replays themselves, their counters and spans. No
JAX here: the card's tests run in this file."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from audiobench import catalog, program
from opencl_fft_tpu_torch import interop
from opencl_fft_tpu_torch import stream as tstream
from opencl_fft_tpu_torch.models import ZeroLatencyConvolver, plan_segments
from opencl_fft_tpu_torch.models import lowlatency as LL
from opencl_fft_tpu_torch.utils import profiling as PF

B = 64


@pytest.fixture(autouse=True)
def _fresh():
    PF.reset()
    yield
    PF.reset()


def _ir(taps: int, seed: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(taps) * np.exp(-np.arange(taps) / (taps / 4))).astype(np.float32)


def _blocks(n: int, seed: int = 9) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, B)).astype(np.float32)


def _zl_counters() -> dict:
    return {k: v for k, v in PF.counters().items() if k.startswith("zl.")}


def _profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _within(inner, outer) -> bool:
    return outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def _in_place(ir, pmax, device="cpu") -> ZeroLatencyConvolver:
    """A convolver whose ``process`` runs the phases' bodies eagerly."""
    zl = ZeroLatencyConvolver(ir, block=B, pmax=pmax, device=device)
    zl._phases = LL._Phases(zl, capture=False)
    return zl


def _run_beside(a, b, xs, swaps=()):
    """Both convolvers over xs; at each (t, how) of swaps, before callback t,
    both reset (``"reset"``) or a's state replaced by b's through numpy
    (``"numpy"``). The pairs of outputs, each beside a copy taken when it
    was returned."""
    swaps = dict(swaps)
    outs = []
    for t, x in enumerate(xs):
        if swaps.get(t) == "reset":
            a.reset()
            b.reset()
        elif swaps.get(t) == "numpy":
            a.state = interop.zl_state_from_numpy(interop.zl_state_to_numpy(b.state), a.device)
        ya, yb = a.process(x), b.process(x)
        outs.append((ya, ya.copy(), yb))
    return outs


# -- the CPU: the phases' bodies in place of their graphs ----------------------

@pytest.mark.parametrize("taps,pmax", [(1 << 14, 1024), (1 << 10, 1024), (B, 256)],
                         ids=["terminal", "doubling-only", "head-only"])
def test_phase_bodies_are_the_eager_step_bit_for_bit(taps, pmax):
    """Over 3 P callbacks (the first P eager), through a reset and a state
    assigned from numpy, each output equals ``_step``'s bit for bit; an
    output kept earlier is unchanged after later callbacks (no view of the
    pinned buffer is returned)."""
    ir = _ir(taps)
    a = _in_place(ir, pmax)
    b = ZeroLatencyConvolver(ir, block=B, pmax=pmax, device="cpu")
    P = a._phases.period
    assert P == max([s.pts // B for s in a.segments] + [2])
    outs = _run_beside(a, b, _blocks(3 * P), {P + 5: "reset", 2 * P + 3: "numpy"})
    for t, (got, kept, want) in enumerate(outs):
        np.testing.assert_array_equal(got, want, err_msg=f"callback {t}")
        np.testing.assert_array_equal(got, kept, err_msg=f"callback {t} changed later")
    assert a.state is a._phases.published and a.state.t == b.state.t
    for mine, ref in zip(LL._owned(a.state, None), LL._owned(b.state, None)):
        assert torch.equal(mine, ref)


def test_the_terminal_plan_and_its_period():
    """2^14 taps at B 64, pmax 1024: four doubling segments of one
    partition and a terminal of 15, which fires eagerly once in P = 16;
    the cell's plan has P = 64."""
    zl = _in_place(_ir(1 << 14), 1024)
    ph = zl._phases
    assert [s.nparts for s in zl.segments] == [1, 1, 1, 1, 15]
    assert ph.period == 16 and ph.terminal == 4
    assert ph.fires == [sum(p % r == r - 1 for r in (1, 2, 4, 8, 16)) for p in range(16)]
    assert ph.captured_fires[15] == ph.fires[15] - 1 and ph.last_fires.count(True) == 1
    assert LL._period(plan_segments(1 << 20, 64, 4096), 64) == 64
    assert LL._period([], 64) == 2


def test_a_state_off_the_cadence_takes_the_eager_step():
    """A head pointer that no phase's graph serves: the eager step runs,
    and the path takes the state back once it is on the cadence. (The
    states come from the eager convolver: a state the path published holds
    the tensors it updates in place.)"""
    ir = _ir(1 << 12)
    a = _in_place(ir, 512)
    b = ZeroLatencyConvolver(ir, block=B, pmax=512, device="cpu")
    xs = _blocks(2 * a._phases.period + 4)
    _run_beside(a, b, xs[:a._phases.period + 1])

    def head_at(state, wp):
        return state._replace(head=state.head._replace(wp=wp))

    a.state = b.state = head_at(b.state, (b.state.head.wp + B) % (2 * B))
    ya, yb = a.process(xs[-1]), b.process(xs[-1])
    np.testing.assert_array_equal(ya, yb)
    assert a._phases.published is not a.state
    a.state = b.state = head_at(b.state, b.state.t * B % (2 * B))
    for t, (got, _, want) in enumerate(_run_beside(a, b, xs[:8])):
        np.testing.assert_array_equal(got, want, err_msg=f"callback {t}")
    assert a._phases.published is a.state


@pytest.mark.parametrize("n", [16, 37])
def test_phase_path_counts_and_spans(n):
    """The phases' path counts ``zl.steps`` and the cadence's firings as
    the eager step does (``step.blocks`` included), ``zl.replays`` 0 where
    no graph was captured; each step is a ``zl`` request holding
    ``replay`` (each firing's ``step`` inside it, the bodies running
    eagerly here) and ``download``."""
    ir = _ir(1 << 12)
    zl = _in_place(ir, 256)
    P = zl._phases.period
    for x in _blocks(P, seed=1):
        zl.process(x)
    PF.reset()
    rs = [s.pts // B for s in zl.segments]
    with _profiled():
        for x in _blocks(n):
            zl.process(x)
    c = _zl_counters()
    assert c["zl.steps"] == n and c["zl.replays"] == 0
    assert c["zl.fires"] == sum(n // r for r in rs)
    assert c["zl.terminal_fires"] == n // rs[-1]
    assert PF.counters()["step.blocks"] == c["zl.fires"]
    assert c["zl.step_ns"] > 0 and c["zl.download_ns"] > 0
    sp = PF.spans()
    reqs = {s.request: s for s in sp if s.parent is None}
    assert len(reqs) == n and {s.name for s in reqs.values()} == {"zl"}
    for r, top in reqs.items():
        kids = sorted((s for s in sp if s.request == r and s.parent == "zl"),
                      key=lambda s: s.start_ns)
        assert [s.name for s in kids] == ["replay", "download"]
        assert all(_within(s, top) for s in kids)
        assert all(s.parent == "replay" and _within(s, kids[0])
                   for s in sp if s.request == r and s.name == "step")
    assert len([s for s in sp if s.name == "step"]) == c["zl.fires"]


def test_eager_steps_count_no_replays_on_the_cpu():
    """The CPU has no graph path: no ``_Phases``, no ``zl.replays``."""
    zl = ZeroLatencyConvolver(_ir(1 << 10), block=B, pmax=256, device="cpu")
    assert zl._phases is None
    with _profiled():
        for x in _blocks(4):
            zl.process(x)
    assert "zl.replays" not in _zl_counters() and _zl_counters()["zl.steps"] == 4


def test_the_processor_hands_its_message_channel_to_the_engine():
    said = []
    p = tstream.ClconvProcessor(_ir(1 << 10), 0, block_size=B, pmax=256, device="cpu",
                                on_message=lambda msg, ud: said.append((msg, ud)), user_data=7)
    p._engine.on_message("graph path off", p._engine.user_data)
    assert said[-1] == ("graph path off", 7)


# -- the reader of the replays' share -------------------------------------------

REPO = Path(__file__).resolve().parents[1]
READER = "zl_replay_pct.zl"


@pytest.mark.parametrize("counts,want", [
    ({"zl.steps": 640, "zl.replays": 630, "zl.fires": 1270}, 100.0 * 630 / 640),
    ({"zl.steps": 640, "zl.replays": 0}, 0.0),
    ({"zl.steps": 640, "zl.fires": 1270}, None),
    ({"zl.replays": 0}, None),
    ({}, None),
    (None, None)])
def test_replay_share_reader(monkeypatch, counts, want):
    """100 x ``zl.replays`` / ``zl.steps``; nothing where the program counts
    no ``zl.replays`` (no graph path, or no counters at all) or no step."""
    if counts is None:
        monkeypatch.setattr(program, "_profiling", lambda: None)
    else:
        monkeypatch.setattr(program, "counters", lambda: counts)
    got = catalog.reader(REPO, READER)({"counters": {}, "untraced": {}})
    assert got == (pytest.approx(want) if want is not None else None)


def test_replay_share_is_a_metric_of_the_zero_latency_cell():
    (m,) = [m for m in catalog.benchmark(REPO)["per_layer"] if m["name"] == READER]
    assert m["workloads"] == ["zl2p20_live64"] and m["moves"] == "audio_s_per_s.opcode"
    assert (m["layer"], m["unit"], m["better"], m["source"]) == (
        "models", "%", "higher", "program_counter")


# -- the card: the replays ------------------------------------------------------

CARD_TAPS, CARD_PMAX = 1 << 16, 4096


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the graph path and the block-step kernels have no "
                    "CPU mode)")
    return torch.device("cuda", 0)


def _eager_beside(ir, dev):
    """The card's eager steps: a convolver without its graph path."""
    zl = ZeroLatencyConvolver(ir, block=B, pmax=CARD_PMAX, device=dev)
    zl._phases = None
    return zl


@pytest.mark.cuda
def test_card_replays_match_the_eager_step():
    """At pmax 4096 (the terminal on the #11 route) over 3 x 64 callbacks,
    a reset in the third cycle: the replays give the eager steps' outputs
    bit for bit (the float64 GEMV of the head included), 64 graphs are
    captured and none again after the reset."""
    dev = _card()
    ir = _ir(CARD_TAPS)
    a = ZeroLatencyConvolver(ir, block=B, pmax=CARD_PMAX, device=dev)
    b = _eager_beside(ir, dev)
    assert a._phases is not None and a._phases.period == 64
    outs = _run_beside(a, b, _blocks(3 * 64), {2 * 64 + 9: "reset"})
    for t, (got, kept, want) in enumerate(outs):
        np.testing.assert_array_equal(got, want, err_msg=f"callback {t}")
        np.testing.assert_array_equal(got, kept)
    assert a._phases.failed is None and a._phases.captures == 64
    assert a.state is a._phases.published


@pytest.mark.cuda
def test_card_terminal_step_graph_matches_the_eager_terminal():
    """At pmax 4096 the terminal segment (15 partitions on the #11 route)
    fires by its step graph (``ops/pconv.StepGraph``), whose MAC reads the
    ring pointer from device memory: over 4 cycles the outputs equal the
    eager steps' bit for bit, the terminal's engine state too, and each
    terminal firing of the graph path but its first (eager) one is a
    replay (``step.replays``: 2 of 4, the first cycle's being the eager
    step's)."""
    dev = _card()
    ir = _ir(CARD_TAPS)
    a = ZeroLatencyConvolver(ir, block=B, pmax=CARD_PMAX, device=dev)
    b = _eager_beside(ir, dev)
    n = 4 * 64
    with _profiled():
        outs = _run_beside(a, b, _blocks(n, seed=4))
    for t, (got, kept, want) in enumerate(outs):
        np.testing.assert_array_equal(got, want, err_msg=f"callback {t}")
    graph = a._phases.term_graph
    assert graph is not None and graph.graph is not None and graph.failed is None
    assert a.state.segs[-1].eng is graph.published
    for k in ("spec_x_re", "spec_x_im", "spec_h_re", "spec_h_im", "tail"):
        assert torch.equal(getattr(a.state.segs[-1].eng, k), getattr(b.state.segs[-1].eng, k))
    assert (a.state.segs[-1].eng.wp, a.state.segs[-1].eng.wp2) == (
        b.state.segs[-1].eng.wp, b.state.segs[-1].eng.wp2)
    assert PF.counters()["step.replays"] == n // 64 - 2


@pytest.mark.cuda
def test_card_counters_count_the_cadence():
    """Traced from t = 0 over 3 x 64 callbacks: ``zl.replays`` is
    ``zl.steps`` less the eager cycle; ``zl.fires``, ``zl.terminal_fires``
    and ``step.blocks`` are the cadence's counts."""
    dev = _card()
    zl = ZeroLatencyConvolver(_ir(CARD_TAPS), block=B, pmax=CARD_PMAX, device=dev)
    n = 3 * 64
    rs = [s.pts // B for s in zl.segments]
    with _profiled():
        for x in _blocks(n):
            zl.process(x)
    c = _zl_counters()
    assert c["zl.steps"] == n and c["zl.replays"] == n - 64
    assert c["zl.fires"] == sum(n // r for r in rs)
    assert c["zl.terminal_fires"] == n // rs[-1] == 3
    assert PF.counters()["step.blocks"] == c["zl.fires"]


@pytest.mark.cuda
def test_card_spans_nest_as_stated():
    """The graph path's twin of ``test_torch_zl_cell.py::
    test_spans_nest_as_stated``: each replayed step is a ``zl`` request
    holding ``replay`` then ``download``, the terminal's ``step`` inside
    ``replay``."""
    dev = _card()
    zl = ZeroLatencyConvolver(_ir(CARD_TAPS), block=B, pmax=CARD_PMAX, device=dev)
    for x in _blocks(2 * 64, seed=2):
        zl.process(x)
    PF.reset()
    n = 64
    with _profiled():
        for x in _blocks(n):
            zl.process(x)
    sp = PF.spans()
    reqs = {s.request: s for s in sp if s.parent is None}
    assert len(reqs) == n and {s.name for s in reqs.values()} == {"zl"}
    for r, top in reqs.items():
        kids = sorted((s for s in sp if s.request == r and s.parent == "zl"),
                      key=lambda s: s.start_ns)
        assert [s.name for s in kids] == ["replay", "download"]
        assert all(_within(s, top) for s in kids)
        assert all(s.parent == "replay" and _within(s, kids[0])
                   for s in sp if s.request == r and s.name == "step")
    steps = [s for s in sp if s.name == "step"]
    assert len(steps) == 1 == _zl_counters()["zl.terminal_fires"]
    assert _zl_counters()["zl.replays"] == n


@pytest.mark.cuda
def test_a_failed_capture_leaves_the_eager_step_and_says_so_once(monkeypatch):
    """A body that the capture refuses (a host sync): the path goes off for
    good, says why once, and the eager step serves every callback with
    the same answers; random draws on the card work after it."""
    dev = _card()
    ir = _ir(1 << 12)
    said = []
    a = ZeroLatencyConvolver(ir, block=B, pmax=512, device=dev)
    a.on_message = lambda msg, ud: said.append(msg)
    b = ZeroLatencyConvolver(ir, block=B, pmax=512, device=dev)
    b._phases = None
    real = a._phases._body

    def body(p, state):
        after = real(p, state)
        torch.cuda.synchronize()
        return after

    monkeypatch.setattr(a._phases, "_body", body)
    for t, (got, _, want) in enumerate(_run_beside(a, b, _blocks(3 * a._phases.period))):
        np.testing.assert_array_equal(got, want, err_msg=f"callback {t}")
    assert a._phases.failed and a._phases.captures == 0
    assert len(said) == 1 and "graph path off" in said[0]
    assert torch.randn(4, device=dev).isfinite().all()      # the generator is settled
