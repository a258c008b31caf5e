"""Fixtures of the benchmark's own tests: a copy of the benchmark in a
temporary directory with every configuration and mix cut to a size the
CPU runs in a second, and a helper that runs one cell there in process."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from audiobench import run

REPO = Path(__file__).resolve().parent.parent

TINY_CONFIGS = {"lti_ir2p17_m512_44k": dict(taps=256, partition=16, sample_rate=4000),
                "tv_ir2p22_m8192_44k": dict(taps=256, partition=32, sample_rate=4000)}
TINY_MIXES = {"stream64_470": dict(channels=4, blocks=5, check_calls=3),
              "stream1_512": dict(blocks=6, check_calls=3),
              "csound_ksmps64": dict(samples=8, pool_blocks=12, check_blocks=4)}
CELLS = ("lti2p17_stream64", "tv2p22_stream1", "tv2p22_csound_ksmps64")
# a cell no BENCHMARK.json entry has, added by the tests from data alone:
# four ClconvProcessor inserts a callback, closed loop
LTI_INSERTS = ("lti_inserts4", "lti_ir2p17_m512_44k",
               {"loop": "callbacks", "instances": 4, "samples": 16, "pool_blocks": 8,
                "check_blocks": 4}, "audio_s_per_s.opcode")


def _update(path: Path, changes: dict) -> None:
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data))


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    root = tmp_path / "bench"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "audiobench", root / "audiobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, changes in TINY_CONFIGS.items():
        _update(root / "audiobench" / "configs" / f"{name}.json", changes)
    for name, changes in TINY_MIXES.items():
        _update(root / "audiobench" / "traffic" / f"{name}.json", changes)
    return root


def add_cell(root: Path, cell: str, config: str, mix: dict, end_to_end: str) -> None:
    """Add a cell to the benchmark under ``root`` as a later change would:
    a mix file, a limits file and entries in BENCHMARK.json, no file edited."""
    ab = root / "audiobench"
    (ab / "traffic" / f"{cell}.json").write_text(json.dumps(mix))
    (ab / "limits" / f"{cell}.json").write_text('{"max_rel_err": 1e-4}')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": cell, "config": config, "traffic": cell, "chips": 1,
                               "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == end_to_end:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def run_cell(root: Path, cell: str, capsys, trace: int = 0, control: int = 0,
             seed: int = 3_000_000_019, seconds: float = 0.3) -> tuple[int, dict | None]:
    """Run one cell on the CPU; (exit code, the last stdout line parsed)."""
    capsys.readouterr()
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace), "--control", str(control)], root=root, device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if rc == 0 and out else None)
