"""Build and load the package's CUDA sources, and check a launch's tensors.

Each ``opencl_fft_tpu_torch/csrc/<name>.cu`` has a plain C interface and
may include the shared headers ``csrc/*.cuh``. It is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library under
``build/opencl_fft_tpu_torch/`` at the repository root, named with a hash of
the source, every header and the flags, on first use in a process, and
loaded with ctypes. A
missing ``nvcc``, a failed build or a failed load raises with the
compiler's output; there is no fall back. ``launch_device`` is the
wrappers' common check of the tensors they hand to a kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "opencl_fft_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {cand} and on PATH); the CUDA "
            f"kernels of opencl_fft_tpu_torch need the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` is (or will be) built: the
    name hashes the source, every ``csrc/*.cuh`` header and the flags, so
    an edit to a shared header builds anew."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is not built yet, and load
    it. The compiler's output is kept beside the library as ``.log``."""
    so = library_path(name)
    if not so.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed building {name}.cu (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, so)
    try:
        return ctypes.CDLL(str(so))
    except OSError as e:
        raise RuntimeError(f"cannot load {so}: {e}") from e


def build_log(name: str) -> str:
    """The compiler's output for the built ``csrc/<name>.cu`` (ptxas
    registers, shared memory and spills per kernel)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA card ``index``: the kernels'
    plans fill the card by it."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_device(name: str, tensors) -> torch.device:
    """The one device of ``tensors``: the CPU (where the wrapper ``name``
    runs its plain twin), or a CUDA card whose tensors are all contiguous
    float32 (where it launches its kernel); anything else raises."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one device")
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: CUDA tensors must be contiguous float32")
    return dev
