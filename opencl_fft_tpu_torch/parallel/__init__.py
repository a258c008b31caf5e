"""Scale-out on ``torch.distributed``: the counterpart of
``opencl_fft_tpu/parallel/``.

A (dp, tp) mesh of process-group ranks (``mesh.py``): dp shards the
channels of a batched convolver, tp its frequency-delay line (the partition
axis), with one all_reduce of the per-block accumulators over tp
(``sharded.py``); ``dist_fft.py`` shards one large transform over an axis
with all_to_all transposes. ``dryrun.py`` starts ranks and runs one sharded
step at the deployment shape against the unsharded engine.
"""

from .dist_fft import dist_fft, dist_fft_split
from .dryrun import dryrun_multichip
from .mesh import Mesh, balanced_shape, make_mesh
from .sharded import (gather_state, make_sharded_pconv_step, make_sharded_pconv_xfade,
                      shard_state, sharded_fft, sharded_pconv_init, sharded_push_ir)

__all__ = ["Mesh", "balanced_shape", "make_mesh", "sharded_fft", "sharded_pconv_init",
           "shard_state", "gather_state", "make_sharded_pconv_step",
           "make_sharded_pconv_xfade", "sharded_push_ir", "dist_fft_split", "dist_fft",
           "dryrun_multichip"]
