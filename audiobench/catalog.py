"""Finds what a cell names, by name, under a benchmark root (the checkout):

    BENCHMARK.json                      the cells and metrics
    audiobench/configs/<config>.json    a deployment: sizes, source, assumptions
    audiobench/traffic/<mix>.json       a traffic mix: its loop and parameters
    audiobench/limits/<cell>.json       the limit of each number compared
    audiobench/metrics/<metric>.py      a per-layer metric's reader, read(records)
    audiobench/loops/<loop>.py          a loop (the code a mix names)

A later change adds a configuration, a mix, a metric or a cell by adding
files and entries; none of these needs an edit of a file that is there.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _file(root: Path, kind: str, name: str, ext: str) -> Path:
    if not _NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = Path(root) / "audiobench" / kind / f"{name}{ext}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return path


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(root: Path, name: str) -> dict:
    return _json(_file(root, "configs", name, ".json"))


def traffic(root: Path, name: str) -> dict:
    return _json(_file(root, "traffic", name, ".json"))


def limits(root: Path, cell_name: str) -> dict:
    return _json(_file(root, "limits", cell_name, ".json"))


def loop(name: str):
    """The loop module a mix names (``audiobench.loops.<name>``)."""
    if not re.match(r"^[a-z_]+$", name):
        raise ValueError(f"bad loop name {name!r}")
    return importlib.import_module(f"audiobench.loops.{name}")


def reader(root: Path, metric: str):
    """The ``read(records)`` function of a per-layer metric."""
    path = _file(root, "metrics", metric, ".py")
    spec = importlib.util.spec_from_file_location(
        "audiobench_metric_" + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, cell_name: str) -> bool:
    """Whether a metric entry of BENCHMARK.json is reported in a cell."""
    return "workloads" not in metric or cell_name in metric["workloads"]
