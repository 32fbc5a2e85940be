"""Training on one device: `long_context.LongContextLM` (the LM's train
step with the flash kernels forward and backward), `train.Trainer` (the
image models, BatchNorm in training mode, float32 master weights, K1 in
every step) and `checkpoint.CheckpointManager` (atomic, retained,
step-indexed checkpoints). Multi-device forms (the mesh, data and
sequence parallelism) are not ported yet: a mesh of more than one
device raises NotImplementedError."""

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
