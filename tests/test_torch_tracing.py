"""The port's program spans and counters (``utils/profiling.py``): recorded
exactly while a torch profiler records, on its clock, at the sites of the
scan entries, the processors and the per-block step. No JAX here: the
``cuda`` case runs on the card with ``--noconftest``."""

import contextlib
import json
import threading
import time

import numpy as np
import pytest
import torch

import opencl_fft_tpu_torch as port
from opencl_fft_tpu_torch.ops import pconv as P
from opencl_fft_tpu_torch.utils import profiling as PF

PROGRAM = ("process.", "feed.", "step.", "spans.")


@pytest.fixture(autouse=True)
def _fresh():
    PF.reset()
    yield
    PF.reset()


@contextlib.contextmanager
def _user_scope(cuda: bool = False):
    """A profiler as the benchmark's traced window runs it: Kineto, the
    device's activity, record_function spans only; yields a list that
    holds (name, is_device, start_ns, end_ns) of its events afterwards."""
    from torch._C._profiler import RecordScope, _ExperimentalConfig
    from torch.autograd import (DeviceType, ProfilerActivity, ProfilerConfig, ProfilerState,
                                _disable_profiler, _enable_profiler, _prepare_profiler)
    acts = {ProfilerActivity.CPU} | ({ProfilerActivity.CUDA} if cuda else set())
    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                         _ExperimentalConfig())
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
    events = []
    try:
        yield events
    finally:
        result = _disable_profiler()
    events.extend((e.name(), e.device_type() != DeviceType.CPU, e.start_ns(),
                   e.start_ns() + e.duration_ns()) for e in result.events())


def _program_counters():
    return {k: v for k, v in PF.counters().items() if k.startswith(PROGRAM)}


def _engine(tv: bool, nch: int = 3, pts: int = 16, taps: int = 128, device="cpu"):
    cfg = port.PconvConfig.for_ir_length(taps, pts)
    if tv:
        return port.TVConvolver(cfg, nch, device=device)
    eng = port.Convolver(cfg, nch, device=device)
    eng.push_ir(torch.randn(nch, taps, generator=torch.Generator().manual_seed(1)))
    return eng


def _stream(eng, tv: bool, nb: int = 5):
    gen = torch.Generator().manual_seed(nb)
    x = torch.randn(nb, eng.batch, eng.cfg.pts, generator=gen).to(eng.device)
    return eng.stream(x, torch.randn(x.shape, generator=gen).to(eng.device)) if tv \
        else eng.stream(x)


@pytest.mark.parametrize("tv", [False, True])
@pytest.mark.parametrize("profiler", ["user_scope", "torch.profiler"])
def test_stream_records_its_stages(tv, profiler):
    """Each stream call is a request holding window, launch and ring, in
    that order, inside its span."""
    eng = _engine(tv)
    _stream(eng, tv)                                 # untraced: nothing
    assert PF.spans() == []
    ctx = _user_scope() if profiler == "user_scope" else \
        torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    with ctx:
        for _ in range(3):
            _stream(eng, tv)
    sp = PF.spans()
    requests = [s for s in sp if s.parent is None]
    assert [s.name for s in requests] == ["stream"] * 3
    assert len({s.request for s in requests}) == 3
    for r in requests:
        kids = sorted((s for s in sp if s.request == r.request and s.parent is not None),
                      key=lambda s: s.start_ns)
        assert [(s.name, s.parent) for s in kids] == [("window", "stream"), ("launch", "stream"),
                                                      ("ring", "stream")]
        assert r.start_ns <= kids[0].start_ns
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
        assert kids[-1].end_ns <= r.end_ns


def test_chunked_stream_is_one_request_with_its_clones():
    """``Convolver.stream(chunk=K)`` is one request; its chunks' ring
    clones (``_rings_after`` below nparts) are counted."""
    eng = _engine(False, nch=2, pts=16, taps=128)    # nparts 8
    with _user_scope():
        _stream(eng, False, nb=4)
        eng.stream(torch.randn(6, 2, 16), chunk=3)
    assert [s.name for s in PF.spans() if s.parent is None] == ["stream", "stream"]
    ring = 2 * 16 * 16 * 4                          # (C, 2 nparts, bins) float32
    assert _program_counters() == {"step.ring_clone_bytes": 2 * 2 * ring}


def _processor(tv: bool, pts: int, taps: int):
    if tv:
        return port.CltvconvProcessor(pts, taps, device="cpu")
    ir = np.random.default_rng(2).standard_normal(taps).astype(np.float32)
    return port.ClconvProcessor(ir, pts, device="cpu")


@pytest.mark.parametrize("tv", [False, True])
@pytest.mark.parametrize("k,pts", [(8, 32), (16, 64), (32, 32)])
def test_processor_counters_add_up(tv, k, pts):
    """Firings = callbacks / (partition / callback); the rest accumulate,
    each timed; every firing is a request with upload, step, download."""
    proc = _processor(tv, pts, 4 * pts)
    x = np.random.default_rng(3).standard_normal(40 * pts).astype(np.float32)
    calls = 3 * (pts // k) + 1
    with _user_scope():
        for i in range(calls):
            blk = x[i * k:(i + 1) * k]
            proc.process(blk, blk[::-1]) if tv else proc.process(blk)
    c = _program_counters()
    fired = calls // (pts // k)
    assert c["process.callbacks"] == calls
    assert c.get("process.accumulate_callbacks", 0) == calls - fired
    if calls > fired:
        assert c["process.accumulate_ns"] >= c["feed.accumulate_ns"] > 0
    assert c["step.blocks"] == fired
    sp = PF.spans()
    fires = [s for s in sp if s.parent is None]
    assert [s.name for s in fires] == ["fire"] * fired
    for f in fires:
        kids = sorted((s for s in sp if s.request == f.request and s.parent is not None),
                      key=lambda s: s.start_ns)
        assert [(s.name, s.parent) for s in kids] == [("upload", "fire"), ("step", "fire"),
                                                      ("download", "fire")]
        assert f.start_ns <= kids[0].start_ns and kids[-1].end_ns <= f.end_ns


@pytest.mark.parametrize("tv,nch,pts,nparts", [(True, None, 32, 8), (True, 2, 16, 5),
                                               (False, None, 64, 3), (False, 3, 16, 4)])
def test_ring_clone_bytes_are_the_planes(tv, nch, pts, nparts):
    """On the plain route a TV step clones both coefficient planes and both
    doubled input planes; an LTI step the input planes."""
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts)
    lead = () if nch is None else (nch,)
    state = P.pconv_init(cfg, "cpu") if nch is None else port.batched_state(cfg, nch, "cpu")
    x = torch.randn(*lead, pts)
    with PF.request("fire", True):
        for _ in range(3):
            state, _ = (P.pconv_step_tv(cfg, state, x, x) if tv else P.pconv_step(cfg, state, x))
    plane = int(np.prod(lead, dtype=int)) * nparts * cfg.bins * 4
    per_block = 2 * 2 * plane + (2 * plane if tv else 0)
    assert _program_counters() == {"step.blocks": 3, "step.ring_clone_bytes": 3 * per_block}
    assert [s.name for s in PF.spans()] == ["step"] * 3 + ["fire"]


def test_nothing_is_recorded_with_the_profiler_off():
    lti, tv = _engine(False), _engine(True)
    procs = [_processor(False, 16, 64), _processor(True, 16, 64)]
    launches = {k: v for k, v in PF.counters().items() if k.endswith("LAUNCHES")}
    x = np.ones(8, np.float32)
    for _ in range(5):
        _stream(lti, False)
        _stream(tv, True)
        procs[0].process(x)
        procs[1].process(x, x)
    lti.stream(torch.randn(4, 3, 16), chunk=2)
    assert PF.spans() == [] and _program_counters() == {}
    assert PF.span("x") is PF.request("y", False) is PF.span("z")
    PF.add("step.blocks", 5)
    assert _program_counters() == {}
    assert {k: v for k, v in PF.counters().items() if k.endswith("LAUNCHES")} == launches
    assert not PF.enabled()


def test_counters_show_the_launch_counts(monkeypatch):
    """Every ``*_LAUNCHES`` global of ``ops/cuda/`` by qualified name, read
    where it stands."""
    from opencl_fft_tpu_torch.ops.cuda import blockstep, slidemac, streamstep
    c = PF.counters()
    names = {k for k in c if k.endswith("LAUNCHES")}
    assert len(names) == 19
    assert "opencl_fft_tpu_torch.ops.cuda.streamstep.BATCHED_TV_LAUNCHES" in names
    assert "opencl_fft_tpu_torch.ops.cuda.vmemfft.LAUNCHES" in names
    monkeypatch.setattr(streamstep, "BATCHED_LAUNCHES", 41)
    monkeypatch.setattr(blockstep, "MAC_UNPACK_LAUNCHES", 7)
    monkeypatch.setattr(slidemac, "MACFLOW_TV_LAUNCHES", slidemac.MACFLOW_TV_LAUNCHES + 2)
    d = PF.counters()
    assert d["opencl_fft_tpu_torch.ops.cuda.streamstep.BATCHED_LAUNCHES"] == 41
    assert d["opencl_fft_tpu_torch.ops.cuda.blockstep.MAC_UNPACK_LAUNCHES"] == 7
    assert d["opencl_fft_tpu_torch.ops.cuda.slidemac.MACFLOW_TV_LAUNCHES"] == \
        c["opencl_fft_tpu_torch.ops.cuda.slidemac.MACFLOW_TV_LAUNCHES"] + 2


def test_trace_export_holds_the_spans(tmp_path):
    """``trace()`` writes the program's spans into its Chrome trace, on the
    trace's time base, inside the profiled window's events."""
    eng = _engine(True)
    t0 = time.time_ns()
    with PF.trace(str(tmp_path)):
        _stream(eng, True)
        _stream(eng, True)
    t1 = time.time_ns()
    data = json.loads((tmp_path / "trace.json").read_text())
    base = int(data.get("baseTimeNanoseconds", 0))
    mine = [e for e in data["traceEvents"] if e.get("cat") == "program"]
    assert sorted(e["name"] for e in mine) == sorted(["stream", "window", "launch", "ring"] * 2)
    assert {e["tid"] for e in mine} == {PF.SPAN_TID}
    profiled = [e for e in data["traceEvents"]
                if e.get("ph") == "X" and e.get("cat") != "program"]
    lo = min(e["ts"] for e in profiled)
    hi = max(e["ts"] + e.get("dur", 0) for e in profiled)
    for e in mine:
        assert t0 <= base + e["ts"] * 1e3 and base + (e["ts"] + e["dur"]) * 1e3 <= t1 + 1e3
        if e["name"] == "launch":      # holds the scan twin's operators
            assert lo <= e["ts"] <= hi
    ops = [e for e in profiled if e["name"].startswith("aten::")]
    launch = [e for e in mine if e["name"] == "launch"]
    assert any(a["ts"] <= o["ts"] <= a["ts"] + a["dur"] for a in launch for o in ops)


def test_spans_are_not_profiler_events():
    """No program span is a ``record_function``: the profiler's own events
    carry none of their names."""
    eng = _engine(False)
    with _user_scope() as events:
        _stream(eng, False)
    assert len(PF.spans()) == 4
    assert not {n for n, *_ in events} & {"stream", "window", "launch", "ring"}


def test_spans_share_the_profiler_clock():
    """A span opened around a ``record_function`` starts before it and ends
    after it: the same Unix-epoch clock (another clock would be seconds or
    more away; 50 µs of slack for the profiler's approximate clock)."""
    with _user_scope() as events:
        for _ in range(20):
            with PF.request("outer", True):
                with torch.profiler.record_function("inner"):
                    pass
    outer = sorted((s for s in PF.spans() if s.name == "outer"), key=lambda s: s.start_ns)
    inner = sorted((e for e in events if e[0] == "inner"), key=lambda e: e[2])
    assert len(outer) == len(inner) == 20
    for s, (_, _, a, b) in zip(outer, inner):
        assert s.start_ns - 50_000 <= a < b <= s.end_ns + 50_000
        assert a - s.start_ns < 100_000_000 and s.end_ns - b < 100_000_000


def test_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(PF, "SPAN_CAPACITY", 5)
    for _ in range(3):
        with PF.request("r", True):
            with PF.span("a"):
                pass
    assert len(PF.spans()) == 5
    assert PF.counters()["spans.dropped"] == 1
    assert [s.name for s in PF.spans()] == ["a", "r", "a", "r", "a"]


def test_a_request_is_per_thread():
    """A request open on one thread opens no span on another."""
    opened, done = threading.Event(), threading.Event()

    def other():
        with PF.request("fire", True):
            opened.set()
            done.wait(10)

    t = threading.Thread(target=other)
    t.start()
    opened.wait(10)
    with PF.span("step"):
        PF.add("step.blocks")
    done.set()
    t.join()
    assert [s.name for s in PF.spans()] == ["fire"]
    assert _program_counters() == {}


def test_threads_lose_no_count(monkeypatch):
    """Eight threads, each in a request of its own, count and close spans
    at a short switch interval: every count and every span is kept."""
    import sys
    go = threading.Barrier(8)

    def work():
        go.wait(10)
        with PF.request("r", True):
            for _ in range(2000):
                PF.add("step.blocks")
                with PF.span("s"):
                    PF.count(("process.callbacks", 2))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert _program_counters() == {"step.blocks": 16000, "process.callbacks": 32000}
    sp = PF.spans()
    assert len(sp) == 8 * 2001 and len({s.request for s in sp}) == 8
    assert all(s.parent == "r" for s in sp if s.name == "s")


def test_reset_restarts_the_requests():
    with PF.request("a", True):
        PF.add("x.n", 2)
    PF.reset()
    assert PF.spans() == [] and "x.n" not in PF.counters()
    with PF.request("b", True):
        pass
    assert PF.spans()[0].request == 1


@pytest.mark.cuda
def test_spans_line_up_with_the_device_rows():
    """On a card: each kernel the profiler records starts after the host
    span that enqueued it began, by the launch latency alone (the offset
    between the program's clock and the device rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.randn(1 << 20, device="cuda")
    (x * 2).sum()
    torch.cuda.synchronize()
    with _user_scope(cuda=True) as events:
        for _ in range(50):
            with PF.request("enqueue", True):
                x.mul_(1.0)
            torch.cuda.synchronize()
    spans = sorted((s for s in PF.spans() if s.name == "enqueue"), key=lambda s: s.start_ns)
    kernels = sorted((e for e in events if e[1]), key=lambda e: e[2])
    assert len(kernels) == len(spans) == 50
    lags = [k[2] - s.start_ns for s, k in zip(spans, kernels)]
    print(f"kernel start - span start: min {min(lags) / 1e3:.2f} us, "
          f"median {sorted(lags)[25] / 1e3:.2f} us, max {max(lags) / 1e3:.2f} us")
    assert all(0 < lag < 1_000_000 for lag in lags)
