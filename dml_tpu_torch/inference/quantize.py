"""Weight-only int8 quantization for LM serving: PyTorch counterpart of
dml_tpu/inference/quantize.py.

The big matmul kernels of the blocks (qkv, proj, up, down), lm_head,
and stacked MoE expert tensors become `{"q": int8, "scale": f32}` with
one symmetric scale per output channel (per expert and channel for MoE
tensors). Embeddings, norms and the router stay float. `kernel_of`
dequantizes at use, so quantized and float trees serve through the
same code. The int8 values equal the JAX package's bit for bit on the
same float32 weights: the same IEEE float32 abs-max, division and
round-half-to-even (`torch.round`, like `jnp.round`).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

_BLOCK_MATMULS = ("qkv", "proj", "up", "down")
_TOP_MATMULS = ("lm_head",)


def _quant_tensor(w: torch.Tensor, keep_axes: Tuple[int, ...]) -> Dict[str, torch.Tensor]:
    """Symmetric int8 with one scale per index of `keep_axes` (the axes
    not reduced by abs-max)."""
    wf = w.to(torch.float32)
    keep = tuple(a % w.ndim for a in keep_axes)
    reduce_axes = tuple(i for i in range(w.ndim) if i not in keep)
    amax = wf.abs().amax(dim=reduce_axes, keepdim=True)
    scale = amax.clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.to(torch.float32)}


def _dequant(t: Dict[str, torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    return (t["q"].to(torch.float32) * t["scale"]).to(dtype)


def quantize_lm_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """LM params tree -> same-structure tree with the big matmul kernels
    replaced by {"q": int8, "scale": f32} pairs."""
    out: Dict[str, Any] = {}
    for name, sub in params.items():
        if name.startswith("block_"):
            blk: Dict[str, Any] = {}
            for k, v in sub.items():
                if k in _BLOCK_MATMULS:
                    blk[k] = {"kernel": _quant_tensor(v["kernel"], (-1,))}
                elif k == "moe":
                    moe = dict(v)
                    moe["w_up"] = _quant_tensor(v["w_up"], (0, 2))
                    moe["w_down"] = _quant_tensor(v["w_down"], (0, 2))
                    blk[k] = moe
                else:
                    blk[k] = v
            out[name] = blk
        elif name in _TOP_MATMULS:
            out[name] = {"kernel": _quant_tensor(sub["kernel"], (-1,))}
        else:
            out[name] = sub
    return out


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, dict) and "q" in leaf and "scale" in leaf


def kernel_of(node: Any, dtype: torch.dtype) -> torch.Tensor:
    """`node` is params["block_i"]["qkv"] (a {"kernel": ...} dict), a
    bare tensor, or the quantized form of either; returns the kernel in
    `dtype` (the tensor itself when it already has that dtype)."""
    kern = node["kernel"] if isinstance(node, dict) and "kernel" in node else node
    if is_quantized(kern):
        return _dequant(kern, dtype)
    return kern.to(dtype)


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def quantized_bytes(params: Dict[str, Any]) -> Tuple[int, int]:
    """(bytes now, bytes as float32) across the whole tree."""
    now = f32 = 0
    for leaf in _leaves(params):
        now += leaf.numel() * leaf.element_size()
        f32 += leaf.numel() * 4
    return now, f32
