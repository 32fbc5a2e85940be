"""Vision Transformer (ViT) family in PyTorch.

Counterpart of dml_tpu/models/vit.py, name for name: `patch_embed`,
`cls_token`, `pos_embed`, `block_{i}` (each `ln_attn`, `qkv`, `proj`,
`ln_mlp`, `up`, `down`), `ln_out` and `head`, so the state_dict keys are
the Flax tree's (`params_io` carries the two layer-less parameters,
`cls_token` and `pos_embed`, under their own names).

What must match the Flax graph:
- the patch embedding is a stride-`patch` VALID conv WITH a bias (Flax's
  `nn.Conv` default), and the tokens are its output in NHWC row-major
  order (`x.reshape(b, -1, hidden)` of the JAX graph), whatever the
  memory format;
- the cls token is prepended and `pos_embed` added; both are float32
  parameters (in `param_dtype`) cast to the compute dtype at use;
- pre-LN encoder blocks: LayerNorm (Flax's: eps 1e-6, float32
  statistics, `layers.LayerNorm`), a fused qkv dense split into q, k, v,
  non-causal attention over [B, T, H, D], the output dense and a
  residual; LayerNorm, dense up, GELU in its tanh form (Flax's `nn.gelu`
  default, `approximate=True`), dense down and a residual; the denses
  compute in the compute dtype (`layers.Linear`);
- a final LayerNorm, then the float32 `head` on the cls row and a
  softmax.

The Flax module sizes `pos_embed` from its input at `init`. A PyTorch
module holds its parameters from the start, so `ViT` sizes it from
`image_size` when it is built, and a forward at another size raises a
ValueError naming both token counts.

Attention is pluggable, as in the JAX package: `attention(q, k, v,
causal=False)` on [B, T, H, D]. The module's default is
`reference_attention`, the port's copy of the JAX default (plain
attention in float32), for CPU tensors only: on another device it
raises, as the port runs plain versions only on the CPU. The registry
builds the served and trained models with `attention=ops.
flash_attention.flash_attention`: the flash kernel (K2,
csrc/flash_attention.cu) forward and its backward kernels (K3) on a
CUDA tensor, their plain versions on the CPU. The q, k and v it gets are
strided views of the qkv output (row stride 3 x hidden), which the
kernels read in place. The JAX package holds the same substitution to
its default within 2e-5 in float32 (tests/test_vit.py).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import reference_attention
from .layers import Conv2d, LayerNorm, Linear

AttentionFn = Callable[..., torch.Tensor]  # (q, k, v, causal=...) -> [B, T, H, D]


def plain_attention(q, k, v, *, causal: bool) -> torch.Tensor:
    """`reference_attention` for CPU tensors (the module's default); on
    another device it raises: pass `attention=flash_attention`."""
    if q.device.type != "cpu":
        raise RuntimeError(f"reference_attention is the plain version, for CPU tensors: a "
                           f"{q.device.type} tensor takes attention=flash_attention")
    return reference_attention(q, k, v, causal=causal)


class EncoderBlock(nn.Module):
    """Pre-LN transformer encoder block (non-causal)."""

    def __init__(self, hidden: int, n_heads: int, mlp_dim: int, attention: AttentionFn,
                 dtype: torch.dtype, param_dtype: torch.dtype):
        super().__init__()
        self.hidden, self.n_heads, self.attention = hidden, n_heads, attention

        def dense(cin, cout):
            return Linear(cin, cout, dtype=param_dtype, compute_dtype=dtype)

        self.ln_attn = LayerNorm(hidden, compute_dtype=dtype)
        self.qkv = dense(hidden, 3 * hidden)
        self.proj = dense(hidden, hidden)
        self.ln_mlp = LayerNorm(hidden, compute_dtype=dtype)
        self.up = dense(hidden, mlp_dim)
        self.down = dense(mlp_dim, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        h = self.n_heads
        hd = self.hidden // h
        q, k, v = self.qkv(self.ln_attn(x)).split(self.hidden, dim=-1)
        attn = self.attention(q.view(b, t, h, hd), k.view(b, t, h, hd), v.view(b, t, h, hd),
                              causal=False)
        x = x + self.proj(attn.reshape(b, t, self.hidden))
        y = F.gelu(self.up(self.ln_mlp(x)), approximate="tanh")
        return x + self.down(y)


class ViT(nn.Module):
    """ViT classifier: normalized NHWC images -> float32 class
    probabilities, at the one image size it was built for."""

    def __init__(
        self,
        patch: int = 16,
        hidden: int = 768,
        n_layers: int = 12,
        n_heads: int = 12,
        mlp_dim: int = 3072,
        num_classes: int = 1000,
        attention: Optional[AttentionFn] = None,
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: Optional[torch.dtype] = None,
        image_size: Tuple[int, int] = (224, 224),
    ):
        super().__init__()
        self.dtype = dtype
        self.param_dtype = dtype if param_dtype is None else param_dtype
        self.hidden = hidden
        attention = attention or plain_attention
        self.patch_embed = Conv2d(3, hidden, patch, stride=patch, dtype=self.param_dtype,
                                  compute_dtype=dtype)
        tokens = (image_size[0] // patch) * (image_size[1] // patch) + 1
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden, dtype=self.param_dtype))
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, hidden, dtype=self.param_dtype))
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"block_{i}", EncoderBlock(hidden, n_heads, mlp_dim, attention, dtype,
                                                       self.param_dtype))
        self.ln_out = LayerNorm(hidden, compute_dtype=dtype)
        self.head = nn.Linear(hidden, num_classes)  # float32 head

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = self.patch_embed(x.to(self.dtype).permute(0, 3, 1, 2))
        x = x.permute(0, 2, 3, 1).reshape(b, -1, self.hidden)  # NHWC row-major tokens
        tokens = x.shape[1] + 1
        if tokens != self.pos_embed.shape[1]:
            raise ValueError(f"ViT: the input gives {tokens} tokens (patches + cls), pos_embed "
                             f"holds {self.pos_embed.shape[1]}: the model was built for another "
                             f"image size")
        cls = self.cls_token.to(self.dtype).expand(b, 1, self.hidden)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
        for i in range(self.n_layers):
            x = getattr(self, f"block_{i}")(x)
        x = self.ln_out(x)[:, 0].float()  # cls token, f32 head
        return torch.softmax(self.head(x), dim=-1)


def ViT_B16(num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16,
            param_dtype: Optional[torch.dtype] = None,
            attention: Optional[AttentionFn] = None) -> ViT:
    return ViT(num_classes=num_classes, dtype=dtype, param_dtype=param_dtype,
               attention=attention)


def ViT_S16(num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16,
            param_dtype: Optional[torch.dtype] = None,
            attention: Optional[AttentionFn] = None) -> ViT:
    return ViT(hidden=384, n_layers=12, n_heads=6, mlp_dim=1536, num_classes=num_classes,
               dtype=dtype, param_dtype=param_dtype, attention=attention)


def ViT_Ti16(num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16,
             param_dtype: Optional[torch.dtype] = None,
             attention: Optional[AttentionFn] = None) -> ViT:
    """Tiny variant (3 blocks), fast enough for the CPU tests."""
    return ViT(hidden=192, n_layers=3, n_heads=3, mlp_dim=768, num_classes=num_classes,
               dtype=dtype, param_dtype=param_dtype, attention=attention)
