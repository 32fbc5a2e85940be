"""Training and the forms over several GPUs: `long_context.LongContextLM`
(the LM's train step with the flash kernels forward and backward, on one
device or a dp x sp x tp x ep mesh), `ring_attention` and `ulysses`
(attention over a sequence sharded on sp), `moe` (experts over ep),
`train.Trainer` (the image models, BatchNorm in training mode, float32
master weights, K1 in every step; one device or a dp x tp mesh),
`inference.ShardedInference` (image serving over a dp x tp mesh, in the
param-gather and the Megatron form), `checkpoint.CheckpointManager`
(atomic, retained, step-indexed checkpoints), `mesh` (meshes over
torch.distributed and the collectives), `sharding` (the tp and ep
partition rule), `multihost` (start-up from the cluster spec) and
`pipeline` (stages over pp, `pipeline_apply`)."""

from typing import Mapping

import numpy as np


def mesh_size(mesh) -> int:
    """Devices a mesh asks for: the product of its axis sizes (`mesh` is
    None, a mapping of axis sizes, or an object with such a `.shape`)."""
    if mesh is None:
        return 1
    shape = getattr(mesh, "shape", mesh)
    if not isinstance(shape, Mapping):
        raise TypeError(f"mesh must be None or map axis names to sizes, got {type(mesh).__name__}")
    return int(np.prod([int(v) for v in shape.values()]))


from .mesh import local_mesh, make_mesh  # noqa: E402  (after mesh_size, which they import)
from .sharding import partition_params, replicated  # noqa: E402
from .inference import ShardedInference  # noqa: E402
from .train import Trainer, make_train_step  # noqa: E402
from .ring_attention import ring_attention  # noqa: E402
from .ulysses import ulysses_attention  # noqa: E402

__all__ = ["mesh_size", "make_mesh", "local_mesh", "partition_params", "replicated",
           "ShardedInference", "Trainer", "make_train_step", "ring_attention",
           "ulysses_attention"]
