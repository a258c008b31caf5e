"""Checkpoint / resume for streaming state.

The reference has no persistence; its only state is device-resident ring
buffers and pointers. Every engine state of the port is a NamedTuple of
tensors and int ring pointers (``PconvState``, ``XfadeState``,
``DconvState``, ``ZLState``), so a checkpoint is exact: the leaves are
written, read back, and the stream continues bit for bit.

The file layout is the JAX package's (``opencl_fft_tpu/utils/checkpoint.py``):
one ``.npz`` holding ``__payload__`` (JSON with ``n_leaves`` and ``meta``)
and ``leaf_i`` for the i-th leaf in the JAX flattening order (fields in
declaration order, mapping keys sorted). A ring pointer is an int32 array,
as in the JAX package: a scalar, or a (C,) vector for per-channel pointers
(a tuple of ints here); a bf16 ring is written as float32 (the widening is
exact). So a checkpoint written by the JAX package loads here, and one
written here loads there.
"""

from __future__ import annotations

import json
from typing import Any, Iterator, List, Optional

import numpy as np
import torch


def _is_pointers(x) -> bool:
    """Per-channel ring pointers: a plain tuple of ints (one JAX leaf)."""
    return (type(x) is tuple and len(x) > 0
            and all(isinstance(v, (int, np.integer)) for v in x))


def _children(x) -> Optional[List[Any]]:
    """A node's children in the JAX flattening order, or None for a leaf."""
    if isinstance(x, torch.Tensor) or _is_pointers(x):
        return None
    if isinstance(x, (tuple, list)):
        return list(x)
    if isinstance(x, dict):
        return [x[k] for k in sorted(x)]
    return None


def _leaves(x) -> List[Any]:
    if x is None:
        return []
    kids = _children(x)
    if kids is None:
        return [x]
    return [leaf for k in kids for leaf in _leaves(k)]


def _describe(x) -> str:
    if x is None:
        return "None"
    kids = _children(x)
    if kids is None:
        return "*"
    if isinstance(x, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(x[k])}" for k in sorted(x)) + "}"
    inner = ", ".join(_describe(k) for k in kids)
    if hasattr(x, "_fields"):
        return f"{type(x).__name__}({inner})"
    return f"[{inner}]" if isinstance(x, list) else f"({inner})"


def _to_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(leaf, (bool, float)):
        return np.asarray(leaf)
    if isinstance(leaf, (int, np.integer)) or _is_pointers(leaf):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _from_array(a: np.ndarray, like):
    """Leaf ``a`` shaped, typed and placed as the template leaf ``like``."""
    if isinstance(like, torch.Tensor):
        if tuple(a.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf of shape {a.shape}, template "
                             f"{tuple(like.shape)}")
        return torch.tensor(a, device=like.device).to(like.dtype)
    if isinstance(like, (int, np.integer)) or _is_pointers(like):
        return int(a) if a.ndim == 0 else tuple(int(v) for v in a)
    if isinstance(like, float):
        return float(a)
    return a


def _rebuild(like, leaves: Iterator[Any]):
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        return _from_array(next(leaves), like)
    new = [_rebuild(k, leaves) for k in kids]
    if isinstance(like, dict):
        return dict(zip(sorted(like), new))
    if hasattr(like, "_fields"):
        return type(like)(*new)
    return type(like)(new)


def save_state(path: str, state: Any, meta: dict | None = None) -> None:
    """Serialize a state (nested NamedTuples, tuples, lists and mappings of
    tensors and ints) to ``path`` (.npz) in the JAX package's layout."""
    leaves = _leaves(state)
    arrays = {f"leaf_{i}": _to_array(x) for i, x in enumerate(leaves)}
    payload = {"treedef": _describe(state), "n_leaves": len(leaves), "meta": meta or {}}
    np.savez(path, __payload__=json.dumps(payload), **arrays)


def load_state(path: str, like: Any) -> Any:
    """Restore a state saved by ``save_state`` (here or by the JAX
    package). ``like`` gives the structure, the devices and the dtypes (for
    example a freshly initialized state of the same config); the leaf count
    and each tensor's shape are checked against the file (ValueError)."""
    with np.load(path, allow_pickle=False) as data:
        payload = json.loads(str(data["__payload__"]))
        n = payload["n_leaves"]
        arrays = [data[f"leaf_{i}"] for i in range(n)]
    template = _leaves(like)
    if len(template) != n:
        raise ValueError(f"checkpoint has {n} leaves but template has {len(template)}")
    return _rebuild(like, iter(arrays))


def load_meta(path: str) -> dict:
    with np.load(path, allow_pickle=False) as data:
        return json.loads(str(data["__payload__"]))["meta"]
