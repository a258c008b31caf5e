"""Native host-runtime bindings (ctypes over ``runtime/stream_rt.cpp``).

Provides, under the JAX package's names (``opencl_fft_tpu/runtime``):

* ``NativeBlockAccumulator`` — the C++ partition accumulator with the
  opcode layer's one-partition-latency semantics (opcode.cpp:240-249).
* ``NativeRingBuffer`` — a lock-free SPSC float ring that decouples
  real-time producers from the device worker.
* ``native_available()`` / ``load()`` — the library is built with
  ``g++ -O2 -shared -fPIC`` on first use, into ``build/opencl_fft_tpu_torch/``
  at the repository root (git-ignored), under a name that hashes the source
  and the flags, so an edited source always builds anew and a library is
  never built next to its source.

Where no ``g++`` is on PATH (and no library is built yet), ``load()``
returns None and ``stream.make_accumulator`` takes the numpy accumulator; a
compile error in this source, or a library that does not load, raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().with_name("stream_rt.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "opencl_fft_tpu_torch"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library of ``stream_rt.cpp`` is (or will be) built: the
    name hashes the source and the flags."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libstream_rt_{h.hexdigest()[:16]}.so"


def _build(so: Path, gxx: str) -> None:
    """Compile the source into ``so`` (through a temporary name, so a
    concurrent process never loads half a library); raises with the
    compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [gxx, *GXX_FLAGS, "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed building {_SRC.name} (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, so)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fp = ctypes.POINTER(ctypes.c_float)
    lib.rb_new.restype = ctypes.c_void_p
    lib.rb_new.argtypes = [ctypes.c_size_t]
    lib.rb_free.argtypes = [ctypes.c_void_p]
    lib.rb_capacity.restype = ctypes.c_size_t
    lib.rb_capacity.argtypes = [ctypes.c_void_p]
    lib.rb_available.restype = ctypes.c_size_t
    lib.rb_available.argtypes = [ctypes.c_void_p]
    lib.rb_space.restype = ctypes.c_size_t
    lib.rb_space.argtypes = [ctypes.c_void_p]
    lib.rb_write.restype = ctypes.c_size_t
    lib.rb_write.argtypes = [ctypes.c_void_p, fp, ctypes.c_size_t]
    lib.rb_read.restype = ctypes.c_size_t
    lib.rb_read.argtypes = [ctypes.c_void_p, fp, ctypes.c_size_t]
    lib.acc_new.restype = ctypes.c_void_p
    lib.acc_new.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.acc_free.argtypes = [ctypes.c_void_p]
    lib.acc_cnt.restype = ctypes.c_int
    lib.acc_cnt.argtypes = [ctypes.c_void_p]
    lib.acc_set_cnt.restype = None
    lib.acc_set_cnt.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.acc_bufin.restype = fp
    lib.acc_bufin.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.acc_bufout.restype = fp
    lib.acc_bufout.argtypes = [ctypes.c_void_p]
    lib.acc_feed.restype = ctypes.c_int
    lib.acc_feed.argtypes = [ctypes.c_void_p, ctypes.POINTER(fp), fp,
                             ctypes.c_int, ctypes.c_int]
    lib.acc_full.restype = ctypes.c_int
    lib.acc_full.argtypes = [ctypes.c_void_p]
    lib.acc_set_bufout.argtypes = [ctypes.c_void_p, fp]
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The native runtime, built on first use; None only when it is not
    built and no ``g++`` is on PATH. A failed build or load raises."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.is_file():
            gxx = shutil.which("g++")
            if gxx is None:
                return None
            _build(so, gxx)
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            raise RuntimeError(f"cannot load {so}: {e}") from e
        _lib = _bind(lib)
        return _lib


def native_available() -> bool:
    return load() is not None


def _require() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError("native runtime unavailable (no g++ on PATH)")
    return lib


class NativeRingBuffer:
    """Lock-free SPSC float ring (real-time safe on both ends); the
    capacity rounds up to a power of two."""

    def __init__(self, capacity: int):
        lib = _require()
        self._lib = lib
        self._h = lib.rb_new(capacity)
        if not self._h:
            raise MemoryError("rb_new failed")

    @property
    def capacity(self) -> int:
        return self._lib.rb_capacity(self._h)

    def available(self) -> int:
        return self._lib.rb_available(self._h)

    def space(self) -> int:
        return self._lib.rb_space(self._h)

    def write(self, data: np.ndarray) -> int:
        """Write as much of ``data`` as fits; returns the samples written."""
        data = np.ascontiguousarray(data, np.float32)
        return self._lib.rb_write(
            self._h, data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), data.size)

    def read(self, n: int) -> np.ndarray:
        """Up to n samples, oldest first."""
        out = np.empty(n, np.float32)
        got = self._lib.rb_read(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
        return out[:got]

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.rb_free(h)
            self._h = None


class NativeBlockAccumulator:
    """C++ partition accumulator; the contract of ``stream._BlockAccumulator``.

    ``bufin`` ((n_streams, parts)), its ``rows`` and ``bufout`` ((parts,))
    are numpy views of the native buffers, bound once (valid while the
    accumulator lives),
    and ``cnt`` is kept here, so that a callback that cannot fill the
    partition (``stream._accumulate``) crosses into C++ not at all; ``feed``
    hands the count to C++ and takes it back."""

    def __init__(self, parts: int, n_streams: int = 1):
        lib = _require()
        self._lib = lib
        self.parts = parts
        self.n_streams = n_streams
        self._h = lib.acc_new(parts, n_streams)
        if not self._h:
            raise MemoryError("acc_new failed")
        self.cnt = 0
        self.bufin = np.ctypeslib.as_array(lib.acc_bufin(self._h, 0), shape=(n_streams, parts))
        self.rows = tuple(self.bufin)
        self.bufout = np.ctypeslib.as_array(lib.acc_bufout(self._h), shape=(parts,))

    def feed(self, blocks: np.ndarray, run_engine) -> np.ndarray:
        """blocks: (n_streams, k). run_engine(bufin) -> (parts,) output."""
        blocks = np.ascontiguousarray(blocks, np.float32)
        k = blocks.shape[-1]
        out = np.empty(k, np.float32)
        fp = ctypes.POINTER(ctypes.c_float)
        ins = (fp * self.n_streams)(*[blocks[s].ctypes.data_as(fp)
                                      for s in range(self.n_streams)])
        outp = out.ctypes.data_as(fp)
        self._lib.acc_set_cnt(self._h, self.cnt)
        pos = 0
        try:
            while pos < k:
                pos += self._lib.acc_feed(self._h, ins, outp, pos, k)
                if self._lib.acc_full(self._h):
                    result = np.ascontiguousarray(run_engine(self.bufin), np.float32)
                    self._lib.acc_set_bufout(self._h, result.ctypes.data_as(fp))
        finally:
            self.cnt = self._lib.acc_cnt(self._h)
        return out

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.acc_free(h)
            self._h = None


__all__ = ["load", "native_available", "library_path", "NativeRingBuffer",
           "NativeBlockAccumulator"]
