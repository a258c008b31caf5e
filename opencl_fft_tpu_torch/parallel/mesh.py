"""The (dp, tp) mesh of process-group ranks.

Counterpart of ``opencl_fft_tpu/parallel/mesh.py``. The reference has no
distributed execution (one OpenCL device chosen by index); here scale-out
is a 2-D mesh over the ranks of the current ``torch.distributed`` process
group:

  dp: data parallel, independent channels (the batch axis);
  tp: tensor parallel, the partition (frequency-delay-line) axis of the
      partitioned convolver, reduced with an all_reduce.

Rank r sits at (r // tp, r % tp), as the JAX mesh lays its devices out
row-major. Each rank holds one group for its dp column and one for its tp
row; a group's ranks are in ascending order, so a rank's index in its tp
group is its tp coordinate.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..utils.errors import DeviceError, Status


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a (dp, tp) mesh.

    ``shape`` maps each axis to its size (``mesh.shape["tp"]``, as in JAX),
    ``coords`` to this rank's index along it, ``groups`` to the process
    group of this rank's line along it. Tensors of the sharded engines live
    on ``device``.
    """

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, object]
    device: torch.device
    backend: str

    def rows(self, n: int, axis: str = "dp") -> slice:
        """This rank's block of n rows split evenly over ``axis``."""
        d = self.shape[axis]
        if n % d:
            raise ValueError(f"{n} rows do not split over {axis}={d}")
        lo = self.coords[axis] * (n // d)
        return slice(lo, lo + n // d)


def make_mesh(shape: Optional[Tuple[int, int]] = None, backend: Optional[str] = None,
              device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """Build the (dp, tp) mesh over the ranks of the current process group
    (``torch.distributed.init_process_group`` first, on every rank; every
    rank calls this with the same shape). Default shape: every rank on dp.
    Meant to be called once a process group: each call creates new dp and
    tp groups, which live as long as the process group.

    The default is the card: the NCCL backend and ``cuda:{rank mod cards}``.
    DeviceError when a card is asked for and there is none; ValueError when
    the group's backend is not ``backend`` or the shape does not cover the
    world.
    """
    backend = backend or "nccl"
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceError("failed to find a CUDA device!", Status.DEVICE_NOT_FOUND)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, not {backend!r}")
    if shape is None:
        shape = (world, 1)
    dp, tp = shape
    if dp < 1 or tp < 1 or dp * tp != world:
        raise ValueError(f"mesh shape {tuple(shape)} does not cover {world} ranks")
    grid = np.arange(world).reshape(dp, tp)
    groups = {}
    # every rank creates every group, in the same order
    for axis, lines in (("dp", grid.T), ("tp", grid)):
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = g
    return Mesh(shape={"dp": dp, "tp": tp}, coords={"dp": rank // tp, "tp": rank % tp},
                groups=groups, device=dev, backend=backend)


def balanced_shape(n: int) -> Tuple[int, int]:
    """Factor n ranks into a near-square (dp, tp) grid."""
    dp = 1
    for d in range(int(np.sqrt(n)), 0, -1):
        if n % d == 0:
            dp = d
            break
    return dp, n // dp
