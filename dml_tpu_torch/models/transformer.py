"""Decoder-only transformer LM: PyTorch counterpart of
dml_tpu/models/transformer.py.

The module keeps the JAX package's parameter names and layouts, so the
flattened Flax params tree is its state_dict: `embed.embedding` [V, d],
`block_i.{ln_attn,ln_mlp}.scale` [d], `block_i.{qkv,proj,up,down}.
kernel` [in, out] (Flax's Dense layout, not nn.Linear's), `ln_out.
scale`, `lm_head.kernel` [d, V]. Parameters are float32 and cast to the
module's dtype at use, as Flax does; the LM head runs in float32.

The default attention is `ops.flash_attention.reference_attention`, the
port's copy of the JAX package's `reference_attention`. Blocks with
experts (`num_experts > 0`) need parallel/moe.py, which is not ported.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..ops.flash_attention import reference_attention

RMS_EPS = 1e-6  # flax nn.RMSNorm default, as used by TransformerLM


def rope_tables(positions: torch.Tensor, d: int, base: float = 10000.0):
    """(cos, sin) of rope's angles for head dim `d`, shaped to broadcast
    over [B, T, H, d // 2]: positions [T] shared across the batch, or
    [B, T] per example. A forward computes them once and rotates every
    layer's q and k with them."""
    half = d // 2
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32, device=positions.device) / half)
    angles = positions[..., None].to(torch.float32) * freqs  # [..., T, half]
    if positions.ndim == 1:
        return torch.cos(angles)[None, :, None, :], torch.sin(angles)[None, :, None, :]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x: torch.Tensor, tables) -> torch.Tensor:
    """Rotate x [B, T, H, D] by `rope_tables`' (cos, sin), in float32,
    rounded once to x's dtype."""
    cos, sin = tables
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding. x: [B, T, H, D]; positions: [T]
    shared across the batch, or [B, T] per example (continuous-batching
    decode, where each slot sits at its own sequence position)."""
    return apply_rope(x, rope_tables(positions.to(x.device), x.shape[-1], base))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Flax RMSNorm as generate.py writes it: reduce in float32, scale,
    cast back to the module dtype."""
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + RMS_EPS)
    return (y * scale.to(torch.float32)).to(dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu as JAX lowers it: x * (1 / (1 + exp(-x))), each step
    rounded to x's dtype. In bf16 this gives JAX's bits, where F.silu
    and torch.sigmoid (one rounding of the float32 value) differ from
    them in about a third of the elements."""
    return x * (1 / (1 + torch.exp(-x)))


class Dense(nn.Module):
    """Bias-free dense layer with a Flax-layout `kernel` [in, out]."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(d_in, d_out))
        self.dtype = dtype

    def forward(self, x):
        return x.to(self.dtype) @ self.kernel.to(self.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.dtype = dtype

    def forward(self, x):
        return rms_norm(x, self.scale, self.dtype)


class Embed(nn.Module):
    def __init__(self, vocab: int, d: int, dtype: torch.dtype):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(vocab, d))
        self.dtype = dtype

    def forward(self, tokens):
        return self.embedding[tokens.long()].to(self.dtype)


class Block(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 attention: Callable[..., torch.Tensor], dtype: torch.dtype = torch.bfloat16,
                 n_kv_heads: Optional[int] = None, num_experts: int = 0):
        super().__init__()
        if num_experts:
            raise NotImplementedError(
                "mixture-of-experts blocks (dml_tpu/parallel/moe.py) are not ported yet: "
                "ROADMAP A, MoE serving"
            )
        kv = n_kv_heads or n_heads
        if n_heads % kv:
            raise ValueError(f"n_kv_heads {kv} must divide n_heads {n_heads}")
        self.d_model, self.n_heads, self.kv = d_model, n_heads, kv
        self.attention = attention
        hd = d_model // n_heads
        self.ln_attn = RMSNorm(d_model, dtype)
        self.qkv = Dense(d_model, d_model + 2 * kv * hd, dtype)
        self.proj = Dense(d_model, d_model, dtype)
        self.ln_mlp = RMSNorm(d_model, dtype)
        self.up = Dense(d_model, d_ff, dtype)
        self.down = Dense(d_ff, d_model, dtype)

    def forward(self, x, tables):
        """x [B, T, d]; `tables` from `rope_tables` for these positions."""
        b, t, _ = x.shape
        h, kv, d = self.n_heads, self.kv, self.d_model
        hd = d // h
        qkv = self.qkv(self.ln_attn(x))
        q = apply_rope(qkv[..., :d].reshape(b, t, h, hd), tables)
        k = apply_rope(qkv[..., d:d + kv * hd].reshape(b, t, kv, hd), tables)
        v = qkv[..., d + kv * hd:].reshape(b, t, kv, hd)
        if kv != h:
            # broadcast KV groups to full heads at use: the attention
            # functions stay head-symmetric, as in the JAX module
            k = k.repeat_interleave(h // kv, dim=2)
            v = v.repeat_interleave(h // kv, dim=2)
        attn = self.attention(q, k, v, causal=True).reshape(b, t, d)
        x = x + self.proj(attn)
        y = self.up(self.ln_mlp(x))
        return x + self.down(silu(y))


class TransformerLM(nn.Module):
    """Causal LM: tokens [B, T] int -> logits [B, T, vocab] f32."""

    def __init__(self, vocab_size: int = 32_000, d_model: int = 512, n_heads: int = 8,
                 n_layers: int = 6, d_ff: int = 2048,
                 attention: Optional[Callable[..., torch.Tensor]] = None,
                 dtype: torch.dtype = torch.bfloat16, n_kv_heads: Optional[int] = None,
                 num_experts: int = 0, moe_every: int = 2):
        super().__init__()
        attn = attention or reference_attention
        # the Flax module's fields, which LongContextLM.generate reads
        self.vocab_size, self.d_model, self.n_heads, self.d_ff = vocab_size, d_model, n_heads, d_ff
        self.n_kv_heads, self.dtype = n_kv_heads, dtype
        self.n_layers, self.head_dim = n_layers, d_model // n_heads
        self.embed = Embed(vocab_size, d_model, dtype)
        for i in range(n_layers):
            is_moe = num_experts > 0 and i % moe_every == moe_every - 1
            self.add_module(f"block_{i}", Block(
                d_model, n_heads, d_ff, attn, dtype, n_kv_heads,
                num_experts if is_moe else 0,
            ))
        self.ln_out = RMSNorm(d_model, dtype)
        self.lm_head = Dense(d_model, vocab_size, torch.float32)

    def forward(self, tokens):
        x = self.embed(tokens)
        tables = rope_tables(torch.arange(tokens.shape[1], device=x.device), self.head_dim)
        for i in range(self.n_layers):
            x = getattr(self, f"block_{i}")(x, tables)
        return self.lm_head(self.ln_out(x).to(torch.float32))
