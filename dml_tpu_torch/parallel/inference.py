"""Batched image inference over a dp x tp mesh: PyTorch counterpart of
dml_tpu/parallel/inference.py.

The engine's forward (`ops.preprocess.normalize_sharded`, so K1 on a
CUDA batch, then the model) spread over a `parallel.mesh.Mesh`, one
process per rank, every rank given the same images: each rank runs its
dp index's rows of each padded chunk, and the probabilities are
all-gathered over dp, so every rank returns the whole [n, classes]
array. The weights stay tp-sharded at rest (`sharding.partition_params`:
dim 0 of every tensor of the state_dict over tp; each rank holds its
piece), in one of the JAX package's two forms:

- `param_gather=True` (the serving-group form): the pieces are
  all-gathered over tp at forward entry (one collective per dtype), and
  each rank runs the one-device program on its rows, so the output is
  the one-device engine's, bit for bit, where the device computes each
  row independently of its batch-mates;
- `param_gather=False` (the Megatron form): each conv and linear layer
  whose weight is sharded computes its block of output channels from its
  piece, and the block is all-gathered over tp along the channels before
  the next layer; BatchNorm (per channel, in eval mode) runs on the
  gathered channels with its vectors gathered at forward entry (C floats
  each). The output agrees with one device to float tolerance.

Entry points run on `cuda` unless `device` says otherwise, and raise
when there is no CUDA device; the tests pass `device="cpu"`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..models.lm_params import resolve_device
from ..models.params_io import from_flax_variables, init_variables
from ..models.registry import get_model
from ..ops.preprocess import normalize_sharded
from .mesh import all_gather, resolve_mesh
from .sharding import gather_tree, partition_params, shard, shard_dim


def _tensor_slot(module: nn.Module, name: str) -> torch.Tensor:
    owner, _, leaf = name.rpartition(".")
    return getattr(module.get_submodule(owner), leaf)


def _layout(t: torch.Tensor) -> torch.Tensor:
    """A 4-D weight in channels-last memory, as the engine holds it."""
    return t.contiguous(memory_format=torch.channels_last) if t.ndim == 4 else t


class ShardedInference:
    """A model over a mesh. The batch size must be a multiple of the dp
    axis; `__call__` pads ragged chunks up to it.

    >>> sh = ShardedInference("ResNet50", local_mesh(dp=2, tp=2), batch_size=32)
    >>> probs = sh(images_u8)   # on every rank: float32 [n, 1000]
    """

    def __init__(
        self,
        model_name: str,
        mesh,
        batch_size: int,
        variables: Any = None,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        param_gather: bool = False,
        device=None,
    ):
        """`mesh` is a `parallel.mesh.Mesh` that this rank is in (every
        rank of it builds the object with the same arguments), or None /
        a one-device mesh. `variables` is the JAX package's layout
        (converted by `from_flax_variables`) or a state_dict; default: the
        port's seeded init."""
        self.spec = get_model(model_name)
        self.mesh = resolve_mesh(mesh)
        self.param_gather = bool(param_gather)
        dp = 1 if self.mesh is None else self.mesh.shape["dp"]
        if batch_size % dp != 0:
            raise ValueError(f"batch_size {batch_size} not divisible by dp={dp}")
        self.batch_size, self.dtype = batch_size, dtype
        self.device = resolve_device(device)
        if variables is None:
            variables = init_variables(self.spec, seed=seed)
        elif "params" in variables or any("/" in k for k in variables):
            variables = from_flax_variables(variables)
        self.num_classes = int(variables["predictions.bias"].shape[-1])
        model = self.spec.build(dtype=dtype, num_classes=self.num_classes)
        model.load_state_dict(variables)  # strict: names any missing/extra key
        self.model = model.to(self.device, memory_format=torch.channels_last).eval()
        # at rest, this rank's piece of every tensor of the state_dict
        full = self.model.state_dict()
        self._specs = partition_params(full, self.mesh or {})
        self._pieces = {n: shard(t, self._specs[n], self.mesh) for n, t in full.items()}
        self._sharded = [n for n in full if shard_dim(self._specs[n]) is not None]
        # the Megatron form computes with the pieces of the conv and linear
        # layers whose weights are sharded, and gathers their outputs
        self._local = set()
        if not self.param_gather:
            for name, m in self.model.named_modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)) and f"{name}.weight" in self._sharded:
                    self._local.update(f"{name}.{leaf}" for leaf in ("weight", "bias")
                                       if getattr(m, leaf) is not None)
                    m.register_forward_hook(self._gather_channels)
        self._release()

    def _gather_channels(self, module, inputs, out: torch.Tensor) -> torch.Tensor:
        """A layer's output-channel blocks, all-gathered over tp."""
        if out.ndim == 4:  # channels-last NCHW: gather NHWC along its last dim
            return all_gather(out.permute(0, 2, 3, 1), self.mesh, "tp", 3).permute(0, 3, 1, 2)
        return all_gather(out, self.mesh, "tp", out.ndim - 1)

    def _load(self) -> None:
        """The tensors the forward computes with into the model: the
        gathered ones, and the Megatron form's pieces."""
        gathered = [n for n in self._sharded if n not in self._local]
        full = gather_tree({n: self._pieces[n] for n in gathered},
                           {n: self._specs[n] for n in gathered}, self.mesh) if gathered else {}
        for n in self._sharded:
            _tensor_slot(self.model, n).data = _layout(full[n] if n in full else self._pieces[n])

    def _release(self) -> None:
        for n in self._sharded:
            slot = _tensor_slot(self.model, n)
            slot.data = slot.data.new_empty(0)

    def _forward(self, rows_u8: torch.Tensor) -> torch.Tensor:
        """This rank's uint8 rows on the device -> float32 probabilities of
        the whole chunk (gathered over dp)."""
        with torch.no_grad():
            self._load()
            try:
                with torch.inference_mode():
                    x = normalize_sharded(rows_u8, self.spec.preprocess, self.dtype, self.mesh)
                    probs = self.model(x)
            finally:
                self._release()
        return probs if self.mesh is None else all_gather(probs, self.mesh, "dp", 0)

    def __call__(self, images_u8: np.ndarray) -> np.ndarray:
        """uint8 (N,H,W,3) -> float32 probs (N, classes); N padded up to
        the batch size, chunk by chunk."""
        n, bs = images_u8.shape[0], self.batch_size
        dp, i = (1, 0) if self.mesh is None else (self.mesh.shape["dp"], self.mesh.coords["dp"])
        k = bs // dp
        outs = []
        for start in range(0, n, bs):
            chunk = images_u8[start:start + bs]
            pad = bs - chunk.shape[0]
            if pad:
                chunk = np.concatenate([chunk, np.zeros((pad, *chunk.shape[1:]), np.uint8)])
            rows = torch.from_numpy(np.ascontiguousarray(chunk[i * k:(i + 1) * k]))
            if self.device.type == "cuda":
                rows = rows.pin_memory().to(self.device, non_blocking=True)
            outs.append(self._forward(rows).cpu().numpy()[: bs - pad])
        if not outs:
            return np.zeros((0, self.num_classes), np.float32)
        return np.concatenate(outs)[:n]
