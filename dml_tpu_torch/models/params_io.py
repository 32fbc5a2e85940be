"""Weights for the ported models: deterministic init, and the JAX
package's variables carried across.

Two sources feed a model's `load_state_dict`:

- `init_variables(spec, seed)`: the engine's default weights, drawn
  with Flax's initializers from a `torch.Generator`;
- `from_flax_variables(tree)`: weights in the JAX package's layout,
  either its nested `{'params': ..., 'batch_stats': ...}` tree or the
  flat 'a/b/c'-keyed dict that `dml_tpu.models.params_io.
  save_npz_fixture` writes (read here with `load_npz_fixture`).

Layout mapping (Flax -> PyTorch):
- conv `kernel` HWIO -> `weight` OIHW; dense `kernel` [in, out] ->
  `weight` [out, in]; `bias` -> `bias`
- BN `params/scale`, `params/bias`, `batch_stats/mean`,
  `batch_stats/var` -> `weight`, `bias`, `running_mean`, `running_var`;
  a BN built without a scale (InceptionV3) gets weight = ones
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_CLASS_INDEX_KEY = "__class_index_json__"


def init_variables(spec, seed: int = 0, num_classes: int = 1000) -> Dict[str, torch.Tensor]:
    """Deterministic float32 state_dict (on the CPU) for `spec`.

    Flax's defaults, drawn in module order from `torch.Generator(seed)`:
    conv and dense kernels lecun-normal (a normal truncated at two
    standard deviations, std sqrt(1/fan_in)/0.8796), biases zero, BN
    scale one, bias zero, mean zero, var one. The distribution is
    Flax's; the bits are not JAX's, since the two generators differ.
    A test that needs both packages on the same weights initialises in
    JAX and converts with `from_flax_variables`.
    """
    module = spec.build(dtype=torch.float32, num_classes=num_classes)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=g)
                if m.bias is not None:
                    m.bias.zero_()
    return module.state_dict()


def load_npz_fixture(path: str) -> Tuple[Dict[str, np.ndarray], Optional[str]]:
    """Read a fixture written by `dml_tpu.models.params_io.
    save_npz_fixture`: returns (flat 'a/b/c'-keyed arrays, embedded
    class-index JSON or None). numpy only."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files if k != _CLASS_INDEX_KEY}
        cij = bytes(data[_CLASS_INDEX_KEY]).decode() if _CLASS_INDEX_KEY in data.files else None
    return flat, cij


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


def _leaf_to_torch(key: str, leaf: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    """(torch parameter suffix, array in torch layout) for one leaf."""
    if leaf == "kernel":
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        if arr.ndim == 2:
            return "weight", arr.T  # [in, out] -> [out, in]
        raise ValueError(f"{key!r}: kernel of rank {arr.ndim} has no mapping")
    names = {"bias": "bias", "scale": "weight", "mean": "running_mean", "var": "running_var"}
    if leaf not in names:
        raise KeyError(f"no PyTorch counterpart for Flax leaf {key!r}")
    return names[leaf], arr


def from_flax_variables(
    tree: Mapping[str, Any], module: Optional[nn.Module] = None
) -> Dict[str, torch.Tensor]:
    """Flax variables (nested tree or flat 'a/b/c' dict) -> float32
    state_dict. With `module`, the keys and shapes are checked against
    its state_dict: a missing or extra key raises KeyError naming it, a
    wrong shape raises ValueError."""
    flat = _flatten(tree)
    flat.pop(_CLASS_INDEX_KEY, None)
    sd: Dict[str, torch.Tensor] = {}
    bn_layers, scaled = set(), set()
    for key, value in flat.items():
        parts = key.split("/")
        if len(parts) < 3 or parts[0] not in ("params", "batch_stats"):
            raise KeyError(f"unexpected Flax variable {key!r}")
        layer, leaf = ".".join(parts[1:-1]), parts[-1]
        if parts[0] == "batch_stats":
            bn_layers.add(layer)
        if leaf == "scale":
            scaled.add(layer)
        name, arr = _leaf_to_torch(key, leaf, np.asarray(value, dtype=np.float32))
        sd[f"{layer}.{name}"] = torch.tensor(arr)  # a contiguous copy
    for layer in bn_layers - scaled:
        sd[f"{layer}.weight"] = torch.ones_like(sd[f"{layer}.running_mean"])
    if module is not None:
        want = module.state_dict()
        for k in want:
            if k not in sd:
                raise KeyError(f"Flax variables have no value for {k!r}")
        for k, v in sd.items():
            if k not in want:
                raise KeyError(f"Flax variables hold {k!r}, which the model does not have")
            if tuple(v.shape) != tuple(want[k].shape):
                raise ValueError(
                    f"{k!r}: shape {tuple(v.shape)} from Flax, model expects "
                    f"{tuple(want[k].shape)}"
                )
    return sd
