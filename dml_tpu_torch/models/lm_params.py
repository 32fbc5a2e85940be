"""Weights for the transformer LM: seeded init, and the JAX package's
params tree carried across.

The port's LM params tree is the JAX package's, with torch tensors for
leaves: `{"embed": {"embedding"}, "block_i": {"ln_attn": {"scale"},
"qkv": {"kernel"}, "proj", "ln_mlp", "up", "down"}, "ln_out",
"lm_head"}`, kernels in Flax's [in, out] layout, float32 (or, after
`inference.quantize.quantize_lm_params`, `{"q": int8, "scale": f32}` in
place of a kernel). A mixture-of-experts block holds `"moe":
{"router": {"kernel"} [d, E], "w_up" [E, d, d_ff], "w_down" [E, d_ff,
d]}` in place of up and down. `inference.generate` consumes the tree
directly and `state_dict_of` flattens it for
`models.transformer.TransformerLM`.

`LMConfig` carries no MoE fields (as in the JAX package): which blocks
are MoE comes from the tree (`"moe" in blk`), or, to make one, from the
`num_experts` and `moe_every` arguments of `lm_param_shapes` and
`init_lm_params` (every `moe_every`-th block, as `TransformerLM` lays
them out).

Entry points place the tree on `cuda` unless the caller passes another
device, and raise when there is no CUDA device; the tests pass
`device="cpu"`.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

_DENSE_FFN = ("up/kernel", "down/kernel")
_MOE_FFN = ("moe/router/kernel", "moe/w_up", "moe/w_down")
_BLOCK_LEAVES = ("ln_attn/scale", "qkv/kernel", "proj/kernel", "ln_mlp/scale")


def resolve_device(device=None) -> torch.device:
    """`device`, or `cuda` when it is None; raises if that is a CUDA
    device and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return dev


def _block_shapes(cfg, num_experts: int) -> Dict[str, tuple]:
    """Leaf -> shape of one block: a mixture of `num_experts` experts in
    its FFN, or a dense FFN when that is 0."""
    d, hd, kv, f = cfg.d_model, cfg.head_dim, cfg.kv_heads, cfg.d_ff
    shapes = {"ln_attn/scale": (d,), "qkv/kernel": (d, d + 2 * kv * hd),
              "proj/kernel": (d, d), "ln_mlp/scale": (d,)}
    if num_experts:
        shapes.update({"moe/router/kernel": (d, num_experts),
                       "moe/w_up": (num_experts, d, f), "moe/w_down": (num_experts, f, d)})
    else:
        shapes.update({"up/kernel": (d, f), "down/kernel": (f, d)})
    return shapes


def is_moe_block(i: int, num_experts: int, moe_every: int) -> bool:
    """Whether block i is a mixture of experts: every `moe_every`-th
    block when `num_experts` > 0 (`TransformerLM`'s layout)."""
    return num_experts > 0 and i % moe_every == moe_every - 1


def lm_param_shapes(cfg, num_experts: int = 0, moe_every: int = 2) -> Dict[str, tuple]:
    """Flat 'a/b/c' key -> shape of every float leaf for `cfg` (an
    `inference.generate.LMConfig`), with `num_experts` experts in every
    `moe_every`-th block when `num_experts` > 0."""
    shapes = {
        "embed/embedding": (cfg.vocab_size, cfg.d_model),
        "ln_out/scale": (cfg.d_model,),
        "lm_head/kernel": (cfg.d_model, cfg.vocab_size),
    }
    for i in range(cfg.n_layers):
        e = num_experts if is_moe_block(i, num_experts, moe_every) else 0
        shapes.update({f"block_{i}/{k}": v for k, v in _block_shapes(cfg, e).items()})
    return shapes


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> flat 'a/b/c' dict; a quantized kernel
    ({"q", "scale"}) stays one leaf."""
    flat: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping) and not ({"q", "scale"} == set(v)):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


def init_lm_params(cfg, seed: int = 0, device=None, num_experts: int = 0,
                   moe_every: int = 2) -> Dict[str, Any]:
    """Deterministic float32 params tree for `cfg` (with experts as
    `lm_param_shapes` lays them out), with Flax's initializers: the
    embedding normal with std sqrt(1/d_model) (`nn.Embed`'s variance
    scaling), kernels and expert tensors lecun-normal (a normal truncated
    at two standard deviations, std sqrt(1/fan_in)/0.8796, `nn.Dense`'s
    default and MoEMLP's variance scaling), RMSNorm scales one. fan_in
    is the product of every axis but the last, as Flax counts it: d for
    a [d, out] kernel, E * d for `w_up` [E, d, d_ff] (the expert axis is
    a receptive field to Flax). Drawn in key order from
    `torch.Generator(seed)` on the CPU, so the values do not depend on
    the device; the bits are not JAX's (a test that needs both packages
    on the same weights initialises in JAX and converts with
    `lm_params_from_flax`)."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    flat = {}
    for key, shape in lm_param_shapes(cfg, num_experts, moe_every).items():
        leaf = key.rsplit("/", 1)[1]
        if leaf == "scale":
            t = torch.ones(shape)
        elif leaf == "embedding":
            t = torch.empty(shape).normal_(0.0, shape[1] ** -0.5, generator=g)
        else:
            std = math.prod(shape[:-1]) ** -0.5 / 0.87962566103423978
            t = torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, std, -2 * std, 2 * std,
                                            generator=g)
        flat[key] = t.to(dev)
    return _nest(flat)


def _as_tensor(v: Any, dtype: torch.dtype) -> torch.Tensor:
    """A leaf (numpy, a JAX array, or a CPU tensor such as
    `params_io.variables_from_bytes` gives, bfloat16 included) as a new
    CPU tensor of `dtype`."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", dtype, copy=True)
    return torch.from_numpy(np.array(v, dtype={torch.int8: np.int8, torch.float32: np.float32}[dtype]))


def lm_params_from_flax(tree: Mapping[str, Any], device=None, *, cfg=None) -> Dict[str, Any]:
    """The JAX package's LM params tree (numpy, array or CPU tensor
    leaves; float, or quantized by `quantize_lm_params`) -> the port's tree of tensors
    on `device`. Values are copied exactly (float32 stays float32, int8
    stays int8).

    Keys and shapes are checked block by block; a block whose tree holds
    `moe` is a mixture of experts (E from its router), any other a dense
    block. With `cfg`, every leaf against `cfg`'s shapes (blocks
    0..n_layers-1); without it, every block against the first block of
    its kind, and the top level must be embed, ln_out, lm_head and
    block_0..block_{n-1}. A missing or extra key raises KeyError naming
    it, a wrong shape ValueError."""
    dev = resolve_device(device)
    flat = _flatten(tree)

    def shape_of(v):
        return tuple(np.shape(v["q"] if isinstance(v, Mapping) else v))

    def experts(name):
        router = flat.get(f"{name}/moe/router/kernel")
        return shape_of(router)[-1] if router is not None else 0

    if cfg is not None:
        want = {k: shape for k, shape in lm_param_shapes(cfg).items()
                if not k.startswith("block_")}
        for i in range(cfg.n_layers):
            want.update({f"block_{i}/{k}": v
                         for k, v in _block_shapes(cfg, experts(f"block_{i}")).items()})
    else:
        n_blocks = len({k.split("/")[0] for k in flat if k.startswith("block_")})
        want = {k: shape_of(flat[k]) for k in ("embed/embedding", "ln_out/scale", "lm_head/kernel")
                if k in flat}
        first: Dict[bool, str] = {}  # MoE or dense -> the first block of that kind
        for i in range(n_blocks):
            moe = experts(f"block_{i}") > 0
            ref = first.setdefault(moe, f"block_{i}")
            for leaf in _BLOCK_LEAVES + (_MOE_FFN if moe else _DENSE_FFN):
                want[f"block_{i}/{leaf}"] = shape_of(flat.get(f"{ref}/{leaf}", ()))
    for k in want:
        if k not in flat:
            raise KeyError(f"the params tree has no value for {k!r}")
    for k in flat:
        if k not in want:
            raise KeyError(f"the params tree holds {k!r}, which the LM does not have")
    out = {}
    for k, v in flat.items():
        if shape_of(v) != tuple(want[k]):
            raise ValueError(f"{k!r}: shape {shape_of(v)}, the LM expects {tuple(want[k])}")
        if isinstance(v, Mapping):  # quantized kernel
            q = _as_tensor(v["q"], torch.int8)
            s = _as_tensor(v["scale"], torch.float32)
            want_s = (*q.shape[:-2], 1, q.shape[-1])  # one per (expert,) output channel
            if tuple(s.shape) != want_s:
                raise ValueError(f"{k!r}: scale shape {tuple(s.shape)}, expected {want_s}")
            out[k] = {"q": q.to(dev), "scale": s.to(dev)}
        else:
            out[k] = _as_tensor(v, torch.float32).to(dev)
    return _nest(out)


def state_dict_of(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Float params tree -> `TransformerLM` state_dict ('a.b.c' keys)."""
    flat = _flatten(params)
    for k, v in flat.items():
        if isinstance(v, Mapping):
            raise TypeError(f"{k!r} is quantized: TransformerLM takes float weights")
    return {k.replace("/", "."): v for k, v in flat.items()}


def params_tree_of(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """`TransformerLM` state_dict ('a.b.c' keys) -> the params tree that
    `inference.generate` serves (the inverse of `state_dict_of`)."""
    return _nest({k.replace(".", "/"): v for k, v in state_dict.items()})


def _adam_state(opt_state: Any) -> Any:
    """The optax `ScaleByAdamState` (count, mu, nu) inside a chain's
    state (nested tuples)."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu") and hasattr(opt_state, "count"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


def adam_opt_state_from_flax(opt_state: Any, params: Mapping[str, torch.Tensor],
                             convert: Callable[[Any, str], Dict[str, torch.Tensor]]
                             ) -> Dict[str, Any]:
    """optax.adamw's chain state -> `{"count": int, "exp_avg": {name:
    tensor}, "exp_avg_sq": {name: tensor}}`, the form the port's
    trainers carry (`parallel.adamw`). `convert(tree, "mu" | "nu")` turns
    a moment tree into tensors by parameter name; each must hold exactly
    `params`' keys and shapes (KeyError, ValueError otherwise)."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise KeyError("opt_state holds no ScaleByAdamState (count, mu, nu)")
    moments = {}
    for name, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        sd = convert(getattr(adam, name), name)
        if set(sd) != set(params):
            raise KeyError(f"opt_state {name} keys {sorted(set(sd) ^ set(params))} differ from the params'")
        for k, v in sd.items():
            if v.shape != params[k].shape:
                raise ValueError(f"opt_state {name} {k!r}: shape {tuple(v.shape)}, "
                                 f"the param's is {tuple(params[k].shape)}")
        moments[key] = sd
    return {"count": int(np.asarray(adam.count)), **moments}


def lm_train_state_from_flax(state: Mapping[str, Any], device=None) -> Dict[str, Any]:
    """The JAX package's `LongContextLM.state` (`{"params", "opt_state",
    "step"}` with numpy or array leaves; `opt_state` is optax.adamw's
    chain state, whose `ScaleByAdamState` holds count, mu and nu) -> the
    port's train state, as `parallel.long_context.LongContextLM.state`
    holds it: `{"params": TransformerLM state_dict, "opt_state":
    {"count": int, "exp_avg": {name: tensor}, "exp_avg_sq": {name:
    tensor}}, "step": int}`, tensors on `device` (`cuda` unless given).

    Params are converted by `lm_params_from_flax`, with its key and
    shape checks; mu and nu must hold exactly the params' keys and
    shapes (KeyError, ValueError otherwise)."""
    params = state_dict_of(lm_params_from_flax(state["params"], device))
    opt_state = adam_opt_state_from_flax(
        state["opt_state"], params,
        lambda tree, name: state_dict_of(lm_params_from_flax(tree, device)))
    return {"params": params, "opt_state": opt_state, "step": int(np.asarray(state["step"]))}
