"""The readers of the program's own spans and counters
(``audiobench/program.py``, ``audiobench/metrics/*``): known values on
synthetic records, the window's alignment with a planted start, nothing
from a program that records none, and a tiny traced cell on the CPU."""

from __future__ import annotations

import types

import pytest

from audiobench import catalog, program
from audiobench.conftest import CELLS, REPO, run_cell
from opencl_fft_tpu_torch.utils import profiling as PF

SCAN_METRICS = ("prelaunch_us_per_call.batch", "idle_prelaunch_pct.batch")
OPCODE_METRICS = ("process_us_per_callback.opcode", "feed_us_per_callback.opcode",
                  "step_enqueue_us_per_block.opcode", "ring_clone_mb_per_block.opcode")
W0 = 1_792_000_000_123_456_789          # the planted window start, Unix-epoch ns


def _read(name, rec):
    return catalog.reader(REPO, name)(rec)


def _scan_record(monkeypatch, stale: int = 3):
    """Five calls 0.1 s apart in a 1 s window, each a 0.05 s ``call`` span;
    the program's ``stream`` opens 2 + i µs into call i, its ``launch``
    ends 20 ms after that; the device runs 3 ms inside each pre-launch
    stretch and from 1 ms after the launch to the call's end. ``stale``
    requests of an earlier run come first."""
    calls, device, sp = [], [], []
    for j in range(stale):
        a = W0 - 10_000_000_000 + j * 1_000_000
        sp += [PF.Span("launch", a + 10, a + 500, "stream", j + 1),
               PF.Span("stream", a, a + 900, None, j + 1)]
    for i in range(5):
        c0 = 0.01 + 0.1 * i
        calls.append(("call", c0, c0 + 0.05))
        device += [("op", c0 + 0.005, c0 + 0.008), ("op", c0 + 0.021, c0 + 0.05)]
        s0 = W0 + round(c0 * 1e9) + 2_000 + 1_000 * i
        r = stale + i + 1
        sp += [PF.Span("window", s0 + 100, s0 + 200, "stream", r),
               PF.Span("launch", s0 + 300, s0 + 20_000_000, "stream", r),
               PF.Span("ring", s0 + 20_000_100, s0 + 20_000_500, "stream", r),
               PF.Span("stream", s0, s0 + 20_001_000, None, r)]
    monkeypatch.setattr(program, "spans", lambda: sp)
    return {"window_s": 1.0, "device": device, "spans": calls + [("sync", 0.9, 0.95)],
            "counters": {"calls": 5}, "untraced": {}}


def test_scan_readers_on_a_synthetic_record(monkeypatch):
    rec = _scan_record(monkeypatch)
    calls = program.window_calls(rec)
    assert [s.request for _, s, _ in calls] == [4, 5, 6, 7, 8]
    assert program.window_start_ns(calls) == W0 + 2_000
    assert _read("prelaunch_us_per_call.batch", rec) == pytest.approx(20_000.0)
    # 20 ms of host before each launch, 3 ms of it with the device busy
    assert _read("idle_prelaunch_pct.batch", rec) == pytest.approx(5 * 1.7, abs=1e-9)


def test_idle_prelaunch_is_within_the_idle_share(monkeypatch):
    """The pre-launch idle is part of the device's idle: never more."""
    from audiobench import trace
    rec = _scan_record(monkeypatch, stale=0)
    rec["device"] = [("op", 0.0, 0.0155), ("op", 0.6, 0.65)]
    got = _read("idle_prelaunch_pct.batch", rec)
    assert 0 < got <= trace.idle_pct(rec)
    # the first call's stretch [0.010, 0.030] is idle from 0.0155 on
    assert got == pytest.approx(100 * (4 * 0.02 + 0.0145), abs=1e-9)


def test_overlap_of_interval_lists():
    assert program.overlap_s([[0, 1], [2, 3]], [[0.5, 2.5]]) == pytest.approx(1.0)
    assert program.overlap_s([], [[0, 1]]) == 0.0
    assert program.overlap_s([[0, 4]], [[1, 2], [3, 5]]) == pytest.approx(2.0)


def test_opcode_readers_on_synthetic_counters(monkeypatch):
    counts = {"process.callbacks": 1280, "process.accumulate_callbacks": 1270,
              "process.accumulate_ns": 1270 * 25_500, "feed.accumulate_ns": 1270 * 4_250,
              "step.blocks": 10, "step.ring_clone_bytes": 10 * 100_663_296}
    sp = [PF.Span("step", 1_000, 1_000 + 150_000 + 10_000 * i, "fire", i + 1)
          for i in range(10)] + [PF.Span("fire", 0, 10**7, None, 1)]
    monkeypatch.setattr(program, "counters", lambda: counts)
    monkeypatch.setattr(program, "spans", lambda: sp)
    rec = {"window_s": 4.0, "device": [], "spans": [], "counters": {}, "untraced": {}}
    assert _read("process_us_per_callback.opcode", rec) == pytest.approx(25.5)
    assert _read("feed_us_per_callback.opcode", rec) == pytest.approx(4.25)
    assert _read("step_enqueue_us_per_block.opcode", rec) == pytest.approx(195.0)
    assert _read("ring_clone_mb_per_block.opcode", rec) == pytest.approx(100.663296)


@pytest.mark.parametrize("profiling", [None, types.SimpleNamespace()])
def test_a_program_without_spans_reports_nothing(monkeypatch, profiling):
    """An older checkout's ``utils.profiling`` has no spans: each reader
    returns None and raises nothing."""
    import opencl_fft_tpu_torch.utils as utils
    if profiling is None:
        monkeypatch.setattr(program, "_profiling", lambda: None)
    else:
        monkeypatch.setattr(utils, "profiling", profiling)
        assert program._profiling() is None
    rec = {"window_s": 1.0, "device": [("op", 0.1, 0.2)], "spans": [("call", 0.0, 0.5)],
           "counters": {"calls": 1}, "untraced": {}}
    for name in SCAN_METRICS + OPCODE_METRICS:
        assert _read(name, rec) is None


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_traced_cell_prints_the_program_metrics(tiny_root, capsys, cell):
    """On the CPU the program's readers report; the one that needs device
    rows reports nothing. The TV step clones 0.006144 MB a block at the
    tiny shape (partition 32, nparts 8: doubled input planes 2 x 2048 B,
    coefficient planes 2 x 1024 B)."""
    PF.reset()
    rc, line = run_cell(tiny_root, cell, capsys, trace=1)
    PF.reset()
    assert rc == 0 and line["correct"]
    got = line["metrics"]
    if cell == "tv2p22_csound_ksmps64":
        assert set(OPCODE_METRICS) <= set(got) and not set(SCAN_METRICS) & set(got)
        assert got["ring_clone_mb_per_block.opcode"]["value"] == pytest.approx(0.006144)
        assert got["ring_clone_mb_per_block.opcode"]["unit"] == "MB"
        assert got["process_us_per_callback.opcode"]["value"] > \
            got["feed_us_per_callback.opcode"]["value"] > 0
    else:
        assert "prelaunch_us_per_call.batch" in got and "idle_prelaunch_pct.batch" not in got
        assert not set(OPCODE_METRICS) & set(got)
        assert got["prelaunch_us_per_call.batch"]["value"] > 0
