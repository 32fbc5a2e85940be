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

Keras weights come in as the JAX package's helpers bring them, in the
Flax layout and with numpy alone: `from_keras_model` (a live Keras
model), `load_keras_h5`/`from_keras_h5` (a Keras .h5 read with h5py, no
TensorFlow) map them onto a Flax-layout variables tree of numpy arrays,
which `from_flax_variables` then turns into a state_dict.
`save_npz_fixture` writes the JAX package's one-file fixture;
`save_checkpoint`/`load_checkpoint` keep such a tree in a directory as
one flax-msgpack file (`variables_to_bytes`). That format is the port's
own: the JAX package's functions of those names write and read an orbax
directory (orbax needs jax), so neither package's `load_checkpoint`
reads the other's checkpoint; the JAX package reads the port's file
only through `variables_from_bytes`.

`variables_to_bytes` / `variables_from_bytes` read and write the JAX
package's one-file weights format (flax's msgpack serialization) without
flax, jax or the msgpack package: a map with str keys; array leaves as
msgpack ext type 1 whose payload packs (shape, dtype name, C-order
bytes), `bfloat16` by name; numpy scalars as ext type 3; a leaf over
2**30 bytes as flax's `__msgpack_chunked_array__` map. Keys are written
sorted, as the JAX package's `variables_to_bytes` writes them, so the
same tree gives the same bytes.

Layout mapping (Flax -> PyTorch):
- conv `kernel` HWIO -> `weight` OIHW (a depthwise kernel (k, k, 1, C)
  -> (C, 1, k, k)); dense `kernel` [in, out] -> `weight` [out, in];
  `bias` -> `bias`
- BN `params/scale`, `params/bias`, `batch_stats/mean`,
  `batch_stats/var` -> `weight`, `bias`, `running_mean`, `running_var`;
  a BN built without a scale (InceptionV3) gets weight = ones;
  LayerNorm `scale`, `bias` -> `weight`, `bias`
- a parameter of the top module itself (ViT's `params/cls_token` and
  `params/pos_embed`) keeps its name and layout
"""

from __future__ import annotations

import os
import re
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_CLASS_INDEX_KEY = "__class_index_json__"


def init_variables(spec, seed: int = 0, num_classes: int = 1000) -> Dict[str, torch.Tensor]:
    """Deterministic float32 state_dict (on the CPU) for `spec`.

    Flax's defaults, drawn in module order from `torch.Generator(seed)`:
    conv and dense kernels lecun-normal (a normal truncated at two
    standard deviations, std sqrt(1/fan_in)/0.8796), biases zero, BN
    scale one, bias zero, mean zero, var one, LayerNorm scale one and
    bias zero; ViT's `pos_embed` normal with std 0.02 and `cls_token`
    zero. Nothing is drawn from torch's global generator, so one seed
    gives one set of weights in every process. The distribution is
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
            if isinstance(getattr(m, "pos_embed", None), nn.Parameter):  # ViT
                nn.init.normal_(m.pos_embed, 0.0, 0.02, generator=g)
                m.cls_token.zero_()
    return module.state_dict()


def load_npz_fixture(path: str) -> Tuple[Dict[str, np.ndarray], Optional[str]]:
    """Read a fixture written by `dml_tpu.models.params_io.
    save_npz_fixture`: returns (flat 'a/b/c'-keyed arrays, embedded
    class-index JSON or None). numpy only."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files if k != _CLASS_INDEX_KEY}
        cij = bytes(data[_CLASS_INDEX_KEY]).decode() if _CLASS_INDEX_KEY in data.files else None
    return flat, cij


def _numpy(leaf: Any) -> np.ndarray:
    """A leaf as a numpy array; a torch tensor from the CPU (bfloat16,
    which numpy lacks, as float32: exact)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """`fn` on every leaf of a nested dict (a dict is a node, anything
    else a leaf)."""
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ----------------------------------------------------------------------
# Keras -> Flax-layout conversion (numpy only)
# ----------------------------------------------------------------------

def _keras_layer_weights(layer) -> Dict[str, np.ndarray]:
    """Extract a keras layer's weights keyed by role."""
    cls = type(layer).__name__
    ws = [np.asarray(w) for w in layer.get_weights()]
    if cls == "Conv2D":
        out = {"kernel": ws[0]}
        if len(ws) > 1:
            out["bias"] = ws[1]
        return out
    if cls == "DepthwiseConv2D":
        # keras depthwise kernel is (k, k, C, depth_multiplier); flax
        # grouped conv (feature_group_count=C) wants (k, k, 1, C)
        out = {"kernel": ws[0].transpose(0, 1, 3, 2)}
        if len(ws) > 1:
            out["bias"] = ws[1]
        return out
    if cls == "Dense":
        return {"kernel": ws[0], "bias": ws[1]}
    if cls == "BatchNormalization":
        # order is [gamma?, beta?, moving_mean, moving_var]
        out: Dict[str, np.ndarray] = {}
        i = 0
        if getattr(layer, "scale", True):
            out["scale"] = ws[i]
            i += 1
        if getattr(layer, "center", True):
            out["bias"] = ws[i]
            i += 1
        out["mean"] = ws[i]
        out["var"] = ws[i + 1]
        return out
    raise ValueError(f"unsupported keras layer {cls}")


def _index_suffix(name: str) -> Tuple[str, int]:
    m = re.match(r"^(.*?)_(\d+)$", name)
    return (m.group(1), int(m.group(2))) if m else (name, -1)


_LAYER_KINDS = ("Conv2D", "DepthwiseConv2D", "Dense", "BatchNormalization")


def _kind_of_roles(roles: Dict[str, np.ndarray]) -> str:
    """Layer kind from a normalized {role: array} dict (the shared
    vocabulary both converters reduce their sources to)."""
    if "mean" in roles:
        return "BatchNormalization"
    k = roles.get("kernel")
    if k is not None and k.ndim == 4:
        # grouped/depthwise convs carry kernel (k, k, 1, C)
        return (
            "DepthwiseConv2D"
            if k.shape[2] == 1 and k.shape[3] > 1
            else "Conv2D"
        )
    return "Dense"


def _apply_keras_layers(
    variables: Mapping[str, Any],
    layers: Dict[str, Dict[str, np.ndarray]],
) -> Dict[str, Any]:
    """Map {keras_layer_name: {role: array}} onto a Flax-layout
    variables tree (numpy or CPU-tensor leaves; `to_flax_variables` of a
    model's state_dict gives one) — the single pairing/copy engine
    behind `from_keras_model` and `from_keras_h5`. Returns a new tree of
    numpy arrays in the template's dtypes.

    Pairing: exact layer-name match first (works for ResNet50, whose
    Keras graph uses stable semantic names like `conv2_block1_1_conv`).
    For layers whose Keras names are autogenerated counters
    (InceptionV3's `conv2d_N`), the pairing key is the numeric name
    suffix: Keras's per-class counters advance once per layer created,
    and the Flax-layout trees number their layers in the same creation
    order, so sorting each type's pool by suffix aligns them
    positionally — regardless of where the Keras counters started (a
    second model in the same process begins at `conv2d_94`). A
    greedy-by-kernel-shape pairing would silently swap same-shaped convs
    across inception branches (b1x1 vs b3x3dbl heads share shapes).
    Every copy is shape-checked, so drift raises instead of silently
    corrupting.
    """
    params = _tree_map(_numpy, variables["params"])
    stats = _tree_map(_numpy, variables.get("batch_stats", {}))
    new_params = {k: dict(v) for k, v in params.items()}
    new_stats = {k: dict(v) for k, v in stats.items()}

    def flax_kind(name: str) -> str:
        if name in stats:
            return "BatchNormalization"
        return _kind_of_roles(params.get(name, {}))

    pools: Dict[str, list] = {t: [] for t in _LAYER_KINDS}
    for name in params.keys():
        pools[flax_kind(name)].append(name)
    for t in pools:
        pools[t].sort(key=_index_suffix)
    kpools: Dict[str, list] = {t: [] for t in _LAYER_KINDS}
    for name, roles in layers.items():
        kpools[_kind_of_roles(roles)].append(name)

    def copy_weights(fname: str, roles: Dict[str, np.ndarray]) -> None:
        for role, arr in roles.items():
            tgt = (
                new_stats[fname]
                if role in ("mean", "var")
                else new_params[fname]
            )
            if role not in tgt:
                raise ValueError(f"{fname} has no {role} in the Flax tree")
            if tgt[role].shape != arr.shape:
                raise ValueError(
                    f"{fname}.{role}: flax {tgt[role].shape} "
                    f"vs keras {arr.shape}"
                )
            tgt[role] = arr.astype(tgt[role].dtype)

    for t in _LAYER_KINDS:
        if len(pools[t]) != len(kpools[t]):
            raise ValueError(
                f"{t}: flax has {len(pools[t])} layers, "
                f"keras has {len(kpools[t])}"
            )

    if all(n in layers for t in _LAYER_KINDS for n in pools[t]):
        for t in _LAYER_KINDS:
            for fname in pools[t]:
                copy_weights(fname, layers[fname])
    else:
        # creation-order pairing by numeric name suffix (see docstring)
        for t in _LAYER_KINDS:
            for fname, kname in zip(
                pools[t], sorted(kpools[t], key=_index_suffix)
            ):
                copy_weights(fname, layers[kname])

    out = {"params": new_params}
    if new_stats:
        out["batch_stats"] = new_stats
    return _tree_map(np.array, out)  # copies: nothing aliases the template


def from_keras_model(keras_model, variables: Mapping[str, Any]) -> Dict[str, Any]:
    """Map a live Keras model's weights onto a Flax-layout variables
    tree — extracts each layer's weights by role, then defers to
    `_apply_keras_layers` (pairing rules documented there)."""
    layers = {
        l.name: _keras_layer_weights(l)
        for l in keras_model.layers
        if type(l).__name__ in _LAYER_KINDS
    }
    return _apply_keras_layers(variables, layers)


def load_keras_h5(h5_path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Read a Keras weights .h5 directly with h5py — no TensorFlow.

    Returns {layer_name: {role: array}} with roles normalized to the
    Flax tree's vocabulary (kernel/bias/scale/mean/var), including the
    depthwise-kernel transpose. Handles both weights-only files (layer
    groups at the root, e.g. the keras.applications imagenet files the
    reference downloads at models.py:26,51) and full-model saves (a
    'model_weights' group)."""
    import h5py

    def role_of(wname: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
        leaf = wname.rsplit("/", 1)[-1].split(":")[0]
        if "depthwise_kernel" in leaf:
            # keras depthwise (k, k, C, mult) -> flax grouped (k, k, 1, C)
            return "kernel", arr.transpose(0, 1, 3, 2)
        if "kernel" in leaf:
            return "kernel", arr
        if "gamma" in leaf:
            return "scale", arr
        if "beta" in leaf:
            return "bias", arr
        if "moving_mean" in leaf:
            return "mean", arr
        if "moving_variance" in leaf:
            return "var", arr
        if "bias" in leaf:
            return "bias", arr
        raise ValueError(f"unrecognized weight name {wname!r}")

    out: Dict[str, Dict[str, np.ndarray]] = {}
    with h5py.File(h5_path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        layer_names = [
            n.decode() if isinstance(n, bytes) else n
            for n in root.attrs.get("layer_names", list(root))
        ]
        for lname in layer_names:
            g = root[lname]
            wnames = [
                n.decode() if isinstance(n, bytes) else n
                for n in g.attrs.get("weight_names", [])
            ]
            if not wnames:
                continue
            layer: Dict[str, np.ndarray] = {}
            for wn in wnames:
                # weight paths are usually '<layer>/<name>:0' relative
                # to the layer group, sometimes fully qualified
                ds = g[wn] if wn in g else root[wn]
                role, arr = role_of(wn, np.asarray(ds))
                layer[role] = arr
            out[lname] = layer
    if not out:
        raise ValueError(
            f"{h5_path}: no legacy-format layer weights found (expects "
            "the topological Keras h5 layout with layer_names/"
            "weight_names attrs — the format of the stock "
            "keras.applications imagenet files; Keras 3's native "
            ".weights.h5 is a different, role-less layout)"
        )
    return out


def from_keras_h5(h5_path: str, variables: Mapping[str, Any]) -> Dict[str, Any]:
    """Map a Keras .h5 weight file onto a Flax-layout variables tree
    without TensorFlow (drop the stock file in DML_TPU_KERAS_WEIGHTS_DIR
    and this reads it with h5py). Same pairing/copy engine as
    `from_keras_model` (`_apply_keras_layers`), fed from the file
    instead of a live model."""
    return _apply_keras_layers(variables, load_keras_h5(h5_path))


# ----------------------------------------------------------------------
# checkpoints and one-file fixtures of a Flax-layout tree
# ----------------------------------------------------------------------

_CHECKPOINT_FILE = "variables.msgpack"


def save_checkpoint(path: str, variables: Mapping[str, Any]) -> None:
    """Keep a variables tree (numpy or tensor leaves) in the directory
    `path` as one flax-msgpack file, replacing any earlier one there
    atomically (tmp file + `os.replace`). The port's own format, not
    the JAX package's orbax directory (see the module docstring)."""
    path = os.path.abspath(os.path.expanduser(path))
    os.makedirs(path, exist_ok=True)
    dest = os.path.join(path, _CHECKPOINT_FILE)
    tmp = f"{dest}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(variables_to_bytes(variables))
    os.replace(tmp, dest)


def load_checkpoint(path: str, like: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
    """Inverse of `save_checkpoint`: the tree with numpy leaves (a
    bfloat16 leaf as float32, exact). With `like`, the result takes
    like's structure, and a key of like the file lacks raises
    ValueError, a shape unlike like's leaf too; a numpy leaf of like
    gives its dtype."""
    path = os.path.abspath(os.path.expanduser(path))
    with open(os.path.join(path, _CHECKPOINT_FILE), "rb") as f:
        tree = variables_from_bytes(f.read(), like)
    if like is None:
        return _tree_map(_numpy, tree)

    def cast(got, want, key):
        if not isinstance(want, Mapping):
            arr = _numpy(got)
            if tuple(arr.shape) != tuple(want.shape):
                raise ValueError(f"{key}: shape {arr.shape} in the checkpoint, "
                                 f"expected {tuple(want.shape)}")
            return arr.astype(want.dtype) if isinstance(want, np.ndarray) else arr
        return {k: cast(got[k], want[k], f"{key}/{k}") for k in want}

    return cast(tree, like, "")


def save_npz_fixture(
    path: str,
    variables: Mapping[str, Any],
    class_index_json: Optional[str] = None,
) -> None:
    """Write a SINGLE-FILE pretrained-weight fixture: the converted
    variables tree (flat 'a/b/c' keys) plus, optionally, the imagenet
    class-index JSON embedded as a string — so any environment that
    can place ONE file runs the full label-parity report
    (tools/imagenet_parity.py). The JAX package's `load_npz_fixture`
    reads it too. Produce it where weights ARE obtainable with:

        like = to_flax_variables(init_variables(spec), spec.build())
        save_npz_fixture("dml_tpu_ResNet50.npz",
                         from_keras_h5("resnet50_....h5", like),
                         open("imagenet_class_index.json").read())
    """
    flat = {k: _numpy(v) for k, v in _flatten(variables).items()}
    if class_index_json is not None:
        flat[_CLASS_INDEX_KEY] = np.frombuffer(
            class_index_json.encode(), dtype=np.uint8
        )
    np.savez_compressed(path, **flat)


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
        arr = np.asarray(value, dtype=np.float32)
        if len(parts) == 1:  # the top module's own parameter (ViT's cls_token, pos_embed)
            out[parts[0]] = torch.tensor(arr)
            continue
        name, arr = _leaf_to_torch(key, parts[-1], arr)
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
        if top not in collections or not rest or (top == "batch_stats" and "/" not in rest):
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


def to_flax_variables(state_dict: Mapping[str, torch.Tensor],
                      module: Optional[nn.Module] = None) -> Dict[str, Any]:
    """Inverse of `from_flax_variables`: a model's state_dict -> the JAX
    package's nested `{'params': ..., 'batch_stats': ...}` tree of
    float32 CPU tensors in the Flax layout, which `variables_to_bytes`
    writes as a weights file a JAX node loads. With `module`, a BN layer
    built without a scale (its `weight` a buffer of ones, InceptionV3)
    gets no `scale` leaf, as in Flax."""
    scaleless = set()
    if module is not None:
        scaleless = {name for name, m in module.named_modules()
                     if "weight" in getattr(m, "_buffers", {})}
    tree: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        layer, _, leaf = key.rpartition(".")
        arr = value.detach().to("cpu", torch.float32)
        if leaf == "num_batches_tracked":
            continue
        if not layer:  # the top module's own parameter (ViT's cls_token, pos_embed)
            tree["params"][leaf] = arr.contiguous()
            continue
        if leaf == "weight" and arr.ndim == 4:
            top, name, arr = "params", "kernel", arr.permute(2, 3, 1, 0)  # OIHW -> HWIO
        elif leaf == "weight" and arr.ndim == 2:
            top, name, arr = "params", "kernel", arr.t()  # [out, in] -> [in, out]
        elif leaf == "weight" and arr.ndim == 1:
            if layer in scaleless:
                continue
            top, name = "params", "scale"
        elif leaf == "bias":
            top, name = "params", "bias"
        elif leaf in ("running_mean", "running_var"):
            top, name = "batch_stats", leaf[len("running_"):]
        else:
            raise KeyError(f"no Flax counterpart for state_dict entry {key!r}")
        node = tree[top]
        for part in layer.split("."):
            node = node.setdefault(part, {})
        node[name] = arr.contiguous()
    return {k: v for k, v in tree.items() if v}


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


# ----------------------------------------------------------------------
# flax's msgpack weights format, without flax, jax or msgpack
# ----------------------------------------------------------------------

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_MAX_CHUNK_BYTES = 2 ** 30  # flax's MAX_CHUNK_SIZE
_CHUNKED = "__msgpack_chunked_array__"


def _pack_uint_header(out: bytearray, n: int, small: Tuple[int, int], codes: Tuple[int, int, int]):
    """A length header: fix form under small[1] (code small[0] | n), else
    the 8-, 16- or 32-bit form (codes; None where msgpack has none)."""
    if n < small[1]:
        out.append(small[0] | n)
    elif codes[0] is not None and n < 1 << 8:
        out += bytes((codes[0], n))
    elif n < 1 << 16:
        out.append(codes[1])
        out += n.to_bytes(2, "big")
    else:
        out.append(codes[2])
        out += n.to_bytes(4, "big")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, nb in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
            if v < 1 << (8 * nb):
                out.append(code)
                out += v.to_bytes(nb, "big")
                return
        raise OverflowError(f"int {v} does not fit msgpack")
    else:
        for code, nb in ((0xD0, 1), (0xD1, 2), (0xD2, 4), (0xD3, 8)):
            if v >= -(1 << (8 * nb - 1)):
                out.append(code)
                out += v.to_bytes(nb, "big", signed=True)
                return
        raise OverflowError(f"int {v} does not fit msgpack")


def _pack(out: bytearray, obj: Any) -> None:
    """msgpack's encoding of `obj` as msgpack-python writes it
    (use_bin_type), with flax's ext types for arrays and numpy scalars."""
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, (torch.Tensor, np.ndarray)):
        _pack_ext(out, _EXT_NDARRAY, _array_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _array_payload(np.asarray(obj)))
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += np.float64(obj).astype(">f8").tobytes()
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_uint_header(out, len(b), (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, (bytes, bytearray)):
        _pack_uint_header(out, len(obj), (0, 0), (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_uint_header(out, len(obj), (0x90, 16), (None, 0xDC, 0xDD))
        for x in obj:
            _pack(out, x)
    elif isinstance(obj, Mapping):
        _pack_uint_header(out, len(obj), (0x80, 16), (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, str(k))
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialize a {type(obj).__name__}")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_uint_header(out, len(data), (0, 0), (0xC7, 0xC8, 0xC9))
    out.append(code)
    out += data


def _array_payload(a) -> bytes:
    """flax's `_ndarray_to_bytes`: msgpack of (shape, dtype name, C-order
    bytes)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous()
        if a.dtype == torch.bfloat16:
            shape, name, data = tuple(a.shape), "bfloat16", a.view(torch.int16).numpy().tobytes()
        else:
            n = a.numpy()
            shape, name, data = n.shape, n.dtype.name, n.tobytes("C")
    else:
        if a.dtype.hasobject:
            raise ValueError("object arrays cannot be serialized")
        shape, name, data = a.shape, a.dtype.name, a.tobytes("C")
    out = bytearray()
    _pack(out, (tuple(int(s) for s in shape), name, bytes(data)))
    return bytes(out)


def _leaves_as_arrays(obj: Any) -> Any:
    """The tree as the JAX package's `tree_map(np.asarray)` leaves it
    (keys sorted, a scalar a 0-d array); a leaf over 2**30 bytes becomes
    flax's chunked form, {"__msgpack_chunked_array__": True, "shape":
    {"0": ...}, "chunks": {"0": flat piece, ...}}, in flax's key order."""
    if isinstance(obj, Mapping):  # keys sorted, as jax's tree_map leaves them
        return {k: _leaves_as_arrays(obj[k]) for k in sorted(obj, key=str)}
    if obj is None:
        return obj
    if not isinstance(obj, torch.Tensor):
        obj = np.asarray(obj)
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        t = obj.detach().cpu() if isinstance(obj, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(obj))
        if t.numel() * t.element_size() > _MAX_CHUNK_BYTES:
            step = max(1, _MAX_CHUNK_BYTES // t.element_size())
            flat = t.reshape(-1)
            return {_CHUNKED: True, "shape": {str(i): int(s) for i, s in enumerate(t.shape)},
                    "chunks": {str(j): flat[i:i + step] for j, i in enumerate(range(0, flat.numel(), step))}}
    return obj


def variables_to_bytes(variables: Mapping[str, Any]) -> bytes:
    """One file of weights in flax's msgpack format (the JAX package's
    `params_io.variables_to_bytes`): a nested dict of torch tensors,
    numpy arrays or scalars (written as 0-d arrays), keys sorted. flax's
    `serialization.from_bytes` reads it back bit for bit."""
    out = bytearray()
    _pack(out, _leaves_as_arrays(variables))
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.at = 0

    def take(self, n: int) -> memoryview:
        if self.at + n > len(self.buf):
            raise ValueError("msgpack data ends early")
        v = self.buf[self.at:self.at + n]
        self.at += n
        return v

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def read(self, raw: bool = False) -> Any:
        c = self.uint(1)
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self._map(c & 0x0F, raw)
        if 0x90 <= c <= 0x9F:
            return [self.read(raw) for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self._str(c & 0x1F, raw)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        if c in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.uint({0xC4: 1, 0xC5: 2, 0xC6: 4}[c])))
        if c in (0xC7, 0xC8, 0xC9):
            n = self.uint({0xC7: 1, 0xC8: 2, 0xC9: 4}[c])
            return self._ext(self.uint(1), n)
        if c == 0xCA:
            return float(np.frombuffer(self.take(4), ">f4")[0])
        if c == 0xCB:
            return float(np.frombuffer(self.take(8), ">f8")[0])
        if 0xCC <= c <= 0xCF:
            return self.uint(1 << (c - 0xCC))
        if 0xD0 <= c <= 0xD3:
            return int.from_bytes(self.take(1 << (c - 0xD0)), "big", signed=True)
        if 0xD4 <= c <= 0xD8:
            code = self.uint(1)
            return self._ext(code, 1 << (c - 0xD4))
        if c in (0xD9, 0xDA, 0xDB):
            return self._str(self.uint({0xD9: 1, 0xDA: 2, 0xDB: 4}[c]), raw)
        if c in (0xDC, 0xDD):
            return [self.read(raw) for _ in range(self.uint(2 if c == 0xDC else 4))]
        if c in (0xDE, 0xDF):
            return self._map(self.uint(2 if c == 0xDE else 4), raw)
        raise ValueError(f"msgpack: unknown type byte 0x{c:02x}")

    def _str(self, n: int, raw: bool):
        b = bytes(self.take(n))
        return b if raw else b.decode("utf-8")

    def _map(self, n: int, raw: bool) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.read(raw)
            out[k] = self.read(raw)
        return out

    def _ext(self, code: int, n: int) -> Any:
        data = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _array_from_payload(data)
        if code == _EXT_NPSCALAR:
            return _array_from_payload(data).reshape(()).item()
        raise ValueError(f"msgpack: unknown ext type {code}")


def _array_from_payload(data: bytes) -> torch.Tensor:
    """flax's `_ndarray_from_bytes`, into a CPU tensor."""
    shape, name, buf = _Reader(data).read(raw=True)
    shape = tuple(int(s) for s in shape)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        raw = np.frombuffer(buf, np.int16).copy()
        return torch.from_numpy(raw).view(torch.bfloat16).reshape(shape)
    return torch.from_numpy(np.frombuffer(buf, np.dtype(name)).copy()).reshape(shape)


def _unchunk(obj: Any) -> Any:
    if isinstance(obj, dict):
        if obj.get(_CHUNKED):
            shape = tuple(int(obj["shape"][str(i)]) for i in range(len(obj["shape"])))
            chunks = [obj["chunks"][str(i)] for i in range(len(obj["chunks"]))]
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return {k: _unchunk(v) for k, v in obj.items()}
    return obj


def variables_from_bytes(data: bytes, like: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
    """Inverse of `variables_to_bytes`, and the reader of the JAX
    package's weights files: a nested dict of CPU tensors in the stored
    dtypes (bfloat16 included). With `like`, the result takes like's
    structure, and a key of like that the data lacks raises ValueError
    naming its path, as flax's `from_bytes` does."""
    r = _Reader(data)
    tree = _unchunk(r.read())
    if r.at != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.at} bytes after the value")
    if like is None:
        return tree

    def restore(target, state, path):
        if not isinstance(target, Mapping):
            return state
        if not isinstance(state, Mapping):
            raise ValueError(f"{path or '/'}: expected a map, the data holds a {type(state).__name__}")
        missing = set(map(str, target)) - set(state)
        if missing:
            raise ValueError(f"the data has no keys {sorted(missing)} at {path or '/'}")
        return {k: restore(v, state[str(k)], f"{path}/{k}") for k, v in target.items()}

    return restore(like, tree, "")
