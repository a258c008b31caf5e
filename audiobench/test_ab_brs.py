"""The head-tracked binaural cell (``brs24x2_headturn``) on the CPU at a
tiny size, through ``audiobench.run`` with a root of its own: correct
against the plain reference (``reference_brs``), failed by its bfloat16
control and by faults planted in the switch; the head's trajectory; the
cell's readers on synthetic records; and the frozen least work of a
crossfading block, against a hand count."""

from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
import torch

import opencl_fft_tpu_torch as port
from audiobench import catalog, program, roofline, roofline_xfade, signals
from audiobench.conftest import REPO, run_cell
from audiobench.loops import brs

CELL = "brs24x2_headturn"
TINY_CONFIG = dict(inputs=3, outputs=2, orientations=8, taps=256, partition=32,
                   sample_rate=4000)
TINY_MIX = dict(pool_samples=2048, check_blocks=4, yaw_limit_deg=3, turn_max_deg=1)
METRICS = ("device_idle_pct.opcode", "ops_per_block.opcode", "step_enqueue_us_per_block.opcode",
           "switch_us_per_block.brs", "xfade_roofline")


def _update(path, changes: dict) -> None:
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data))


@pytest.fixture
def root(tmp_path):
    root = tmp_path / "bench"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "audiobench", root / "audiobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cell = catalog.cell(catalog.benchmark(root), CELL)
    _update(root / "audiobench" / "configs" / f"{cell['config']}.json", TINY_CONFIG)
    _update(root / "audiobench" / "traffic" / f"{cell['traffic']}.json", TINY_MIX)
    return root


def test_cell_is_correct(root, capsys):
    rc, line = run_cell(root, CELL, capsys, seed=3_100_000_007)
    assert rc == 0 and line["correct"] and line["failed"] == 0
    assert set(line["metrics"]) == {"audio_s_per_s.opcode", "setup_s"}
    assert line["metrics"]["audio_s_per_s.opcode"]["value"] > 0
    assert line["checks"]["max_rel_err"]["value"] < 2e-6


def test_traced_run_reads_the_switch(root, capsys):
    """The CPU has no device trace: of the cell's readers only the
    program's span readers find something (the switch, and the incoming
    path's ``step`` inside each fade block)."""
    rc, line = run_cell(root, CELL, capsys, trace=1, seconds=0.4)
    assert rc == 0 and line["correct"]
    assert set(line["metrics"]) == {"switch_us_per_block.brs",
                                    "step_enqueue_us_per_block.opcode"}
    assert line["metrics"]["switch_us_per_block.brs"]["value"] > 0
    assert line["metrics"]["step_enqueue_us_per_block.opcode"]["value"] > 0


def _not_correct(root, capsys, control=0):
    rc, line = run_cell(root, CELL, capsys, control=control)
    assert rc == 0 and line["correct"] is False and line["failed"] > 0
    return line["checks"]["max_rel_err"]["value"]


def test_control_fails(root, capsys):
    """The reference computed in bfloat16 reads ~4e-3."""
    assert _not_correct(root, capsys, control=1) > 5e-4


@pytest.mark.parametrize("fault", ["no_fade", "stale", "next_yaw", "one_ear"])
def test_faults_in_the_switch_fail(root, capsys, monkeypatch, fault):
    """An instant swap where a fade is due, a switch that never comes, the
    BRIRs of a neighbouring yaw, or an ear left unswitched: not correct."""
    orig = port.MatrixConvolver.switch

    def switch(self, index, fade_blocks=1):
        index = np.asarray(index)
        if fault == "no_fade":
            return orig(self, index, 0)
        if fault == "stale":
            if self._held.max() < 0:
                return orig(self, index, fade_blocks)
            return None
        if fault == "next_yaw":
            return orig(self, (index + 1) % self._bank[0].shape[1], fade_blocks)
        bank = [b.clone() for b in self._bank]
        self._bank[0][:, :, 1] = self._bank[0][:, :, 0]
        self._bank[1][:, :, 1] = self._bank[1][:, :, 0]
        try:
            return orig(self, index, fade_blocks)
        finally:
            self._bank = tuple(bank)

    monkeypatch.setattr(port.MatrixConvolver, "switch", switch)
    assert _not_correct(root, capsys) > 1e-2


def test_configuration_states_the_deployment():
    bench = catalog.benchmark(REPO)
    cell = catalog.cell(bench, CELL)
    cfg = catalog.config(REPO, cell["config"])
    assert cell["chips"] == 1 and cfg["reduced"] == []
    assert (cfg["kind"], cfg["inputs"], cfg["outputs"], cfg["orientations"]) == (
        "brs", 24, 2, 360)
    assert (cfg["taps"], cfg["partition"], cfg["sample_rate"], cfg["dtype"]) == (
        1 << 16, 512, 48000, "float32")
    assert cfg["bank_bytes"] == 24 * 360 * 2 * 128 * 512 * 2 * 4 == 9_059_696_640
    assert {"source", "assumed", "guarantees", "deployment"} <= set(cfg)
    assert len(cfg["source"]) <= 200
    mix = catalog.traffic(REPO, cell["traffic"])
    assert mix == dict(mix, loop="brs", pool_samples=1 << 22, fade_blocks=1, turn_min_deg=1,
                       turn_max_deg=3, yaw_limit_deg=90, check_blocks=16)
    assert catalog.limits(REPO, CELL)["max_rel_err"] == 1e-4
    (e2e,) = [m for m in bench["end_to_end"] if m["name"] == "audio_s_per_s.opcode"]
    assert e2e["workloads"][-1] == CELL and e2e["bound"] == 0.25
    for name in METRICS:
        (m,) = [m for m in bench["per_layer"] if m["name"] == name]
        assert m["moves"] == "audio_s_per_s.opcode" and m["workloads"][-1] == CELL


def _loop(seed: int, **mix) -> brs.Loop:
    cfg = dict(catalog.config(REPO, "brs22p2_brir2p16_m512_48k"))
    full = dict(catalog.traffic(REPO, "headturn_m512"), **mix)
    return brs.Loop(cfg, full, seed, torch.device("cpu"))


@pytest.mark.parametrize("seed", [1, 3_100_000_123, 2**31 + 5])
def test_the_head_turns_every_block(seed):
    """1-3 degrees a block, within +-90, reversing at seeded yaws, so the
    orientation changes on every block; the same seed, the same turns."""
    loop = _loop(seed)
    loop._extend(1 << 13)
    loop._extend(1 << 13)                       # a later draw goes on from the last yaw
    yaws = loop.yaws
    assert len(yaws) >= 1 << 14 and np.abs(yaws).max() <= 90
    steps = np.diff(yaws)
    assert np.abs(steps).min() >= 1 and np.abs(steps).max() <= 3
    reversals = np.flatnonzero(np.sign(steps[1:]) != np.sign(steps[:-1]))
    assert len(reversals) > 50
    assert len(np.unique(yaws % 360)) > 150
    again = _loop(seed)
    again._extend(1 << 14)
    assert np.array_equal(again.yaws[:1 << 14], yaws[:1 << 14])
    assert not np.array_equal(_loop(seed + 1).yaws, yaws)


def test_the_loop_refuses_what_its_reference_cannot_check():
    with pytest.raises(ValueError, match="fade_blocks must be 1"):
        _loop(1, fade_blocks=2)
    with pytest.raises(ValueError, match="orientations"):
        _loop(1, yaw_limit_deg=180)
    with pytest.raises(ValueError, match="whole blocks"):
        _loop(1, pool_samples=1000)


# -- the readers ------------------------------------------------------------------

def _read(name, rec):
    return catalog.reader(REPO, name)(rec)


def _record(**kw) -> dict:
    rec = {"window_s": 4.0, "device": [], "spans": [], "counters": {}, "untraced": {}}
    rec.update(kw)
    return rec


class _Span:
    def __init__(self, name, start, end, parent=None):
        self.name, self.start_ns, self.end_ns, self.parent = name, start, end, parent


def test_readers_on_synthetic_records(monkeypatch):
    monkeypatch.setattr(program, "counters", lambda: {"xfade.blocks": 4})
    monkeypatch.setattr(program, "spans", lambda: [
        _Span("switch", 0, 700_000), _Span("gather", 10, 20, "switch"),
        _Span("switch", 1_000_000, 1_900_000), _Span("switch", 0, 50, "matrix"),
        _Span("step", 0, 300_000, "xfade"), _Span("step", 0, 500_000, "xfade")])
    device = [("mac_kernel", 0.0, 1.0), ("gather", 1.0, 1.5), ("Memcpy HtoD", 1.5, 2.0),
              ("step_inv_kernel", 1.8, 2.5)]
    rec = _record(device=device, counters={"blocks_fired": 4, "least_s": 0.75})
    assert _read("switch_us_per_block.brs", rec) == pytest.approx(400.0)
    assert _read("ops_per_block.opcode", rec) == pytest.approx(1.0)
    assert _read("step_enqueue_us_per_block.opcode", rec) == pytest.approx(400.0)
    # kernels busy 2.2 s (the copy is no kernel): 0.75 / 2.2
    assert _read("xfade_roofline", rec) == pytest.approx(100 * 0.75 / 2.2)
    assert _read("device_idle_pct.opcode", rec) == pytest.approx(100 * (1 - 2.5 / 4.0))


@pytest.mark.parametrize("program_counters", [None, {}, {"step.blocks": 3}])
def test_readers_find_nothing_where_nothing_was_recorded(monkeypatch, program_counters):
    """A program without the switch (the parent of this cell), or a window
    with no kernel: None, and no error."""
    if program_counters is None:
        monkeypatch.setattr(program, "_profiling", lambda: None)
    else:
        monkeypatch.setattr(program, "counters", lambda: program_counters)
        monkeypatch.setattr(program, "spans", lambda: [])
    rec = _record(device=[("k", 0.0, 1.0)], counters={"least_s": 0.1})
    assert _read("switch_us_per_block.brs", rec) is None
    assert _read("step_enqueue_us_per_block.opcode", rec) is None
    assert _read("ops_per_block.opcode", _record(counters={"blocks_fired": 3})) is None
    assert _read("xfade_roofline", _record(counters={"least_s": 0.1})) is None


# -- the frozen least work --------------------------------------------------------

def test_least_work_of_the_cells_block():
    """24 sources x 2 ears, nparts 128, pts 512: the MAC of 48 pairs
    against both coefficient sets, 50.33 MFLOP, and 28 transforms of 1,024
    points (24 forward, 2 ears x 2 paths inverse), 0.72 MFLOP; 50.33 MB of
    the two coefficient sets, 12.58 MB of 24 windows, 53 KB of blocks and
    16 KB of 4 tails in and out: 62.98 MB, 18.80 us at 3.35 TB/s, bound by
    bytes (0.76 us of operations at 67 TFLOP/s)."""
    mac = 2 * 8.0 * 48 * 128 * 512
    fft = 28 * 2.5 * 1024 * 10
    assert mac / 1e6 == pytest.approx(50.33, abs=5e-3)
    assert roofline_xfade.xfade_flops(24, 2, 128, 512) == mac + fft
    planes, windows = 2 * 48 * 128 * 512 * 8, 24 * 128 * 512 * 8
    blocks, tails = 26 * 512 * 4, 2 * 4 * 512 * 4
    assert (planes, windows, blocks, tails) == (50_331_648, 12_582_912, 53_248, 16_384)
    nbytes = roofline_xfade.xfade_bytes(24, 2, 128, 512)
    assert nbytes == planes + windows + blocks + tails == 62_984_192
    least, what = roofline_xfade.xfade_least_ms(24, 2, 128, 512)
    assert least == pytest.approx(nbytes / 3.35e12 * 1e3) and what == "bytes"
    assert least * 1e3 == pytest.approx(18.80, abs=5e-3)
    assert roofline.bound(mac + fft, 0.0)[0] * 1e3 == pytest.approx(0.762, abs=5e-4)


def test_brirs_are_the_signals_draws():
    """Each BRIR is ``signals.decaying_noise`` of a generator seeded by its
    own seed: unit energy, decaying."""
    from audiobench import reference_brs
    cpu = torch.device("cpu")
    h = reference_brs.brirs(5, [1], [7], 2, 512, cpu)[0, 0]
    gen = torch.Generator().manual_seed(reference_brs.brir_seed(5, 1, 7, 1))
    assert torch.equal(h[1], signals.decaying_noise(gen, 1, 512)[0])
    assert torch.allclose(h.norm(dim=-1), torch.ones(2, dtype=torch.float32))
