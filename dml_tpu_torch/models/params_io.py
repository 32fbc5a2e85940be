"""Weights for the ported models: deterministic init, and the JAX
package's variables carried across.

Two sources feed a model's `load_state_dict`, and one a trainer's state:

- `init_variables(spec, seed)`: the engine's default weights, drawn
  with Flax's initializers from a `torch.Generator`;
- `from_flax_variables(tree)`: weights in the JAX package's layout,
  either its nested `{'params': ..., 'batch_stats': ...}` tree or the
  flat 'a/b/c'-keyed dict that `dml_tpu.models.params_io.
  save_npz_fixture` writes (read here with `load_npz_fixture`);
- `image_train_state_from_flax(state)`: the JAX package's image
  `Trainer.state` (params, batch statistics, AdamW moments, step), which
  `parallel.train.Trainer.state` takes, so a JAX run resumes in the port.

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


def params_from_flax(tree: Mapping[str, Any], collection: str = "params") -> Dict[str, torch.Tensor]:
    """One Flax collection (`params`, `batch_stats`, or an optimizer
    moment shaped like `params`), nested or flat 'layer/leaf'-keyed ->
    {'layer.name': float32 tensor} in the PyTorch layout. Errors name a
    leaf as '<collection>/layer/leaf'."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in _flatten(tree, collection).items():
        parts = key[len(collection) + 1:].split("/")
        if len(parts) < 2:
            raise KeyError(f"unexpected Flax variable {key!r}")
        name, arr = _leaf_to_torch(key, parts[-1], np.asarray(value, dtype=np.float32))
        out[f"{'.'.join(parts[:-1])}.{name}"] = torch.tensor(arr)  # a contiguous copy
    return out


def from_flax_variables(
    tree: Mapping[str, Any], module: Optional[nn.Module] = None
) -> Dict[str, torch.Tensor]:
    """Flax variables (nested tree or flat 'a/b/c' dict) -> float32
    state_dict. With `module`, the keys and shapes are checked against
    its state_dict: a missing or extra key raises KeyError naming it, a
    wrong shape raises ValueError."""
    flat = _flatten(tree)
    flat.pop(_CLASS_INDEX_KEY, None)
    collections: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for key, value in flat.items():
        top, _, rest = key.partition("/")
        if top not in collections or "/" not in rest:
            raise KeyError(f"unexpected Flax variable {key!r}")
        collections[top][rest] = value
    stats = params_from_flax(collections["batch_stats"], "batch_stats")
    sd = {**params_from_flax(collections["params"]), **stats}
    for k in stats:  # a BN layer built without a scale: weight = ones
        layer = k.rpartition(".")[0]
        sd.setdefault(f"{layer}.weight", torch.ones_like(stats[f"{layer}.running_mean"]))
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


def image_train_state_from_flax(state: Mapping[str, Any], device=None) -> Dict[str, Any]:
    """The JAX package's `Trainer.state` (`{"params", "batch_stats",
    "opt_state", "step"}` with numpy or array leaves; `opt_state` is
    optax.adamw's chain state, whose `ScaleByAdamState` holds count, mu
    and nu) -> the port's `parallel.train.Trainer.state`: `{"params":
    {name: tensor}, "batch_stats": {name: tensor}, "opt_state": {"count":
    int, "exp_avg": {name: tensor}, "exp_avg_sq": {name: tensor}},
    "step": int}`, PyTorch names and layouts, float32, on `device`
    (`cuda` unless given). mu and nu must hold exactly the params' keys
    and shapes (KeyError, ValueError otherwise)."""
    from .lm_params import adam_opt_state_from_flax, resolve_device

    dev = resolve_device(device)

    def on_device(tree, collection):
        return {k: v.to(dev) for k, v in params_from_flax(tree, collection).items()}

    params = on_device(state["params"], "params")
    return {"params": params,
            "batch_stats": on_device(state["batch_stats"], "batch_stats"),
            "opt_state": adam_opt_state_from_flax(
                state["opt_state"], params,
                lambda tree, name: on_device(tree, f"opt_state/{name}")),
            "step": int(np.asarray(state["step"]))}
