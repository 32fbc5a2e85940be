"""Autoregressive decoding with a KV cache for the transformer LM:
PyTorch counterpart of dml_tpu/inference/generate.py.

- `prefill` runs the whole prompt through one batched forward, with
  causal attention by the flash kernel (`ops.flash_attention`), and
  fills the cache.
- `batched_decode_step` advances every slot one token at its own
  position, with cache attention by the decode kernel
  (`ops.decode_attention`). On CUDA the kernel serves every cache form
  (bf16, f32, int8; MHA, GQA, MQA); there is no switch.
- `generate` is prefill, then a Python loop of decode steps (in place
  of JAX's `lax.scan`) that keeps the tokens on the device: no host
  sync per token.

Same params tree as the JAX package (`models.lm_params`), same layer
math (`_apply_block` is the one copy prefill and decode share; a block
whose tree holds `moe` runs `_moe_ffn`, exact per-token top-2 routing
over every expert), same cache layout (head-major [B, KV, T, D]; int8
scales [B, KV, 1, T]).

Differences from the JAX package, by design:
- The cache is a dict of preallocated tensors updated IN PLACE: a
  decode or verify step writes each slot's row with one batched index
  write, and returns the same dict it was given. Callers that need the
  old cache clone it first.
- `serving_params` casts a float tree's block kernels to the model
  dtype once, at load. `kernel_of` then returns them as they are
  (the cast is the same bits the JAX package makes at every use).
  Int8 trees keep dequantize-at-use, which is their memory saving.
- Sampling (temperature > 0) draws from an explicit `torch.Generator`
  (Gumbel-max, as `jax.random.categorical` does), so sampled tokens
  differ from the JAX package's by construction; greedy decoding is
  deterministic and matches it. `sample_per_request` is the LM
  server's sampler: the token at position p of request rid is a pure
  function of (seed, rid, p) and the logits, drawn with noise from an
  integer hash on the device (not JAX's threefry bits).

Entry points run where their params live: `models.lm_params` puts them
on `cuda` unless asked for the CPU, and `init_cache` does the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.lm_params import resolve_device
from ..models.transformer import rms_norm as _rms_norm
from ..models.transformer import apply_rope, rope_tables, silu
from ..ops.decode_attention import decode_attention
from ..ops.flash_attention import flash_attention
from .quantize import is_quantized, kernel_of

NEG_INF = -1e30


@dataclass(frozen=True)
class LMConfig:
    """Shape config mirroring TransformerLM's fields. `kv_quant=True`
    stores the KV cache as int8 with one f32 scale per (position,
    kv head)."""

    vocab_size: int
    d_model: int
    n_heads: int
    n_layers: int
    d_ff: int
    dtype: torch.dtype = torch.bfloat16
    n_kv_heads: Optional[int] = None  # GQA; None = MHA
    kv_quant: bool = False

    def __post_init__(self):
        kv = self.n_kv_heads
        if kv is not None and (kv <= 0 or self.n_heads % kv):
            raise ValueError(
                f"n_kv_heads {kv} must be positive and divide n_heads {self.n_heads}"
            )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_heads if self.n_kv_heads is None else self.n_kv_heads


def init_cache(cfg: LMConfig, batch: int, max_len: int, device=None) -> Dict[str, Any]:
    """Preallocated zero KV cache: one head-major [B, KV, max_len, D]
    pair per layer, in `cfg.dtype`, or int8 with [B, KV, 1, max_len]
    f32 scales under `cfg.kv_quant`. On `cuda` unless `device` says
    otherwise."""
    dev = resolve_device(device)
    shape = (batch, cfg.kv_heads, max_len, cfg.head_dim)
    if cfg.kv_quant:
        sshape = (batch, cfg.kv_heads, 1, max_len)
        return {
            f"block_{i}": {
                "k_q": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_s": torch.zeros(sshape, dtype=torch.float32, device=dev),
                "v_q": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v_s": torch.zeros(sshape, dtype=torch.float32, device=dev),
            }
            for i in range(cfg.n_layers)
        }
    return {
        f"block_{i}": {
            "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        }
        for i in range(cfg.n_layers)
    }


def serving_params(params: Dict[str, Any], cfg: LMConfig) -> Dict[str, Any]:
    """The tree to serve from: float block kernels and stacked expert
    tensors (`moe.w_up`, `moe.w_down`) cast once to `cfg.dtype`
    (bit-identical to `kernel_of`'s cast at every use), everything else
    (embedding, norms, the router, f32 lm_head, int8 kernels) as it is.
    The router stays as given: `_moe_ffn` routes in float32."""

    def cast(v):
        return v if is_quantized(v) else v.to(cfg.dtype)

    out: Dict[str, Any] = {}
    for name, sub in params.items():
        if name.startswith("block_"):
            blk = {}
            for k, v in sub.items():
                if k == "moe":
                    blk[k] = dict(v, w_up=cast(v["w_up"]), w_down=cast(v["w_down"]))
                elif isinstance(v, dict) and "kernel" in v:
                    blk[k] = {"kernel": cast(v["kernel"])}
                else:
                    blk[k] = v
            out[name] = blk
        else:
            out[name] = sub
    return out


def _kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., D] -> (int8 values, f32 scale over the last axis)."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _kv_dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 + scale -> f32 (the verify step's einsum read side)."""
    return q.to(torch.float32) * scale


def _device_of(params: Dict[str, Any]) -> torch.device:
    return params["embed"]["embedding"].device


# tokens per dense-dispatch chunk: the [chunk, E, d_ff] intermediate
# stays bounded whatever the prompt length
_MOE_CHUNK = 512


def _moe_ffn(moe: Dict[str, Any], y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The MoE FFN at serve time (`parallel.moe.MoEMLP`'s function without
    capacity): y [B, T, d] -> [B, T, d]. Per-token top-2 routing is exact,
    so no token drops (capacity drops are a training-time batching
    artifact). Every expert runs on every token and the outputs are
    combined with the two gate weights, as the JAX package does; runs of
    more than `_MOE_CHUNK` tokens go through in zero-padded chunks of that
    many (pad rows route too and are thrown away). The router runs in
    float32 (a bf16-cast router is promoted exactly, as JAX promotes it);
    the expert products and the combine run in `dtype`."""
    w_up = kernel_of(moe["w_up"], dtype)
    w_down = kernel_of(moe["w_down"], dtype)
    router = kernel_of(moe["router"], torch.float32)

    def dense(tok):  # [n, d] -> [n, d]
        gates = torch.softmax(tok.to(torch.float32) @ router, dim=-1)  # [n, E]
        e = gates.shape[-1]
        m1 = F.one_hot(gates.argmax(-1), e).to(gates.dtype)
        m2 = F.one_hot((gates * (1.0 - m1)).argmax(-1), e).to(gates.dtype)
        g1 = (gates * m1).sum(-1)
        g2 = (gates * m2).sum(-1)
        denom = torch.clamp(g1 + g2, min=1e-9)
        w = m1 * (g1 / denom)[:, None] + m2 * (g2 / denom)[:, None]  # [n, E]
        # batched over experts: [n, d] @ [E, d, d_ff] -> [E, n, d_ff]
        # (torch.einsum's "nd,edf" folds E into one GEMM and copies the
        # whole permuted w_up on every call)
        h = silu(torch.matmul(tok, w_up))
        o = torch.matmul(h, w_down)  # [E, n, d]
        return torch.einsum("end,ne->nd", o, w.to(dtype))

    d = y.shape[-1]
    tok = y.reshape(-1, d)
    n = tok.shape[0]
    if n <= _MOE_CHUNK:
        return dense(tok).reshape(y.shape)
    tokp = F.pad(tok, (0, 0, 0, (-n) % _MOE_CHUNK))
    out = torch.cat([dense(c) for c in tokp.split(_MOE_CHUNK)])
    return out[:n].reshape(y.shape)


def _apply_block(blk, cfg: LMConfig, x, tables, attn_fn):
    """One transformer block, the single copy of the layer math that
    decode (T=1, cache attention) and prefill (T=Tp, flash attention)
    both run. `tables` are rope's (cos, sin) for the positions, made
    once per forward (`rope_tables`). Returns (x_out, k, v) with k/v
    [B, T, KV, D]."""
    b, t = x.shape[:2]
    h, hd, kv, d = cfg.n_heads, cfg.head_dim, cfg.kv_heads, cfg.d_model
    y = _rms_norm(x, blk["ln_attn"]["scale"], cfg.dtype)
    qkv = y @ kernel_of(blk["qkv"], cfg.dtype)  # [B, T, d + 2*kv*hd]
    q = apply_rope(qkv[..., :d].reshape(b, t, h, hd), tables)
    k = apply_rope(qkv[..., d:d + kv * hd].reshape(b, t, kv, hd), tables)
    v = qkv[..., d + kv * hd:].reshape(b, t, kv, hd)
    attn = attn_fn(q, k, v).reshape(b, t, d).to(cfg.dtype)
    x = x + attn @ kernel_of(blk["proj"], cfg.dtype)
    y = _rms_norm(x, blk["ln_mlp"]["scale"], cfg.dtype)
    if "moe" in blk:
        return x + _moe_ffn(blk["moe"], y, cfg.dtype), k, v
    y = silu(y @ kernel_of(blk["up"], cfg.dtype))
    return x + y @ kernel_of(blk["down"], cfg.dtype), k, v


def _head(params, cfg: LMConfig, x_last):
    """Final norm + f32 lm head on [B, 1, d] -> [B, V] f32 logits."""
    x = _rms_norm(x_last, params["ln_out"]["scale"], cfg.dtype)
    return (x.to(torch.float32) @ kernel_of(params["lm_head"], torch.float32))[:, 0, :]


def _max_len(cache) -> int:
    return next(iter(next(iter(cache.values())).values())).shape[2]


@torch.no_grad()
def batched_decode_step(params, cfg: LMConfig, cache, tokens, pos):
    """One decode step with per-slot positions: slot b consumes
    tokens[b] at position pos[b] and attends cache rows <= pos[b].
    Returns (logits [B, V] f32, cache), the cache updated in place."""
    dev = _device_of(params)
    tokens = torch.as_tensor(tokens, device=dev)
    pos = torch.as_tensor(pos, device=dev).to(torch.int32)
    b = tokens.shape[0]
    x = params["embed"]["embedding"][tokens.long()].to(cfg.dtype)[:, None, :]
    tables = rope_tables(pos[:, None], cfg.head_dim)  # [B, 1]: rope's per-example form
    rows, at = torch.arange(b, device=dev), pos.long()

    for i in range(cfg.n_layers):
        lay = cache[f"block_{i}"]

        def attn_fn(q, k, v, lay=lay):
            kh, vh = k[:, 0], v[:, 0]  # [B, KV, D]: one row per slot
            if cfg.kv_quant:
                kq, ks = _kv_quantize(kh)
                vq, vs = _kv_quantize(vh)
                lay["k_q"][rows, :, at] = kq
                lay["k_s"][:, :, 0][rows, :, at] = ks[..., 0]
                lay["v_q"][rows, :, at] = vq
                lay["v_s"][:, :, 0][rows, :, at] = vs[..., 0]
                return decode_attention(q, lay["k_q"], lay["v_q"], pos,
                                        k_scale=lay["k_s"], v_scale=lay["v_s"])
            lay["k"][rows, :, at] = kh.to(cfg.dtype)
            lay["v"][rows, :, at] = vh.to(cfg.dtype)
            return decode_attention(q, lay["k"], lay["v"], pos)

        x, _, _ = _apply_block(params[f"block_{i}"], cfg, x, tables, attn_fn)
    return _head(params, cfg, x), cache


def decode_step(params, cfg: LMConfig, cache, tokens, idx):
    """One decode step with every slot at position `idx` (the shared-
    position case of `batched_decode_step`)."""
    dev = _device_of(params)
    b = torch.as_tensor(tokens).shape[0]
    return batched_decode_step(params, cfg, cache, tokens,
                               torch.full((b,), int(idx), dtype=torch.int32, device=dev))


@torch.no_grad()
def batched_verify_step(params, cfg: LMConfig, cache, tokens, pos):
    """Multi-token decode forward (the speculative-decoding verify
    primitive): slot b consumes tokens[b] ([B, T]) at positions
    pos[b] .. pos[b]+T-1 and gets logits for every one ([B, T, V] f32).
    Same math as T successive `batched_decode_step` calls; attention is
    the float32 einsum, as in the JAX package. Starts are clamped to
    max_len - T. The cache is updated in place."""
    dev = _device_of(params)
    tokens = torch.as_tensor(tokens, device=dev)
    b, t = tokens.shape
    hd, grp = cfg.head_dim, cfg.n_heads // cfg.kv_heads
    x = params["embed"]["embedding"][tokens.long()].to(cfg.dtype)  # [B, T, d]
    max_len = _max_len(cache)
    pos = torch.clamp(torch.as_tensor(pos, device=dev).long(), max=max_len - t)
    positions = pos[:, None] + torch.arange(t, device=dev)[None, :]  # [B, T]
    valid = torch.arange(max_len, device=dev)[None, None, :] <= positions[:, :, None]
    rows = torch.arange(b, device=dev)[:, None]
    tables = rope_tables(positions, hd)

    for i in range(cfg.n_layers):
        lay = cache[f"block_{i}"]

        def attn_fn(q, k, v, lay=lay):
            # k/v [B, T, KV, D]: slot b's rows go to positions[b]
            if cfg.kv_quant:
                kq, ks = _kv_quantize(k)
                vq, vs = _kv_quantize(v)
                lay["k_q"][rows, :, positions] = kq
                lay["k_s"][:, :, 0][rows, :, positions] = ks[..., 0]
                lay["v_q"][rows, :, positions] = vq
                lay["v_s"][:, :, 0][rows, :, positions] = vs[..., 0]
                ck = _kv_dequant(lay["k_q"], lay["k_s"].transpose(2, 3))
                cv = _kv_dequant(lay["v_q"], lay["v_s"].transpose(2, 3))
            else:
                lay["k"][rows, :, positions] = k.to(cfg.dtype)
                lay["v"][rows, :, positions] = v.to(cfg.dtype)
                ck, cv = lay["k"], lay["v"]
            qg = q.to(torch.float32).reshape(b, t, cfg.kv_heads, grp, hd)
            s = torch.einsum("bqkgd,bktd->bkgqt", qg, ck.to(torch.float32)) * (hd ** -0.5)
            s = torch.where(valid[:, None, None, :, :], s, torch.full_like(s, NEG_INF))
            p = torch.softmax(s, dim=-1)
            attn = torch.einsum("bkgqt,bktd->bqkgd", p, cv.to(torch.float32))
            return attn.reshape(b, t, cfg.n_heads, hd)

        x, _, _ = _apply_block(params[f"block_{i}"], cfg, x, tables, attn_fn)

    x = _rms_norm(x, params["ln_out"]["scale"], cfg.dtype)
    return x.to(torch.float32) @ kernel_of(params["lm_head"], torch.float32), cache


@torch.no_grad()
def prefill(params, cfg: LMConfig, prompt, max_len: int, logits_index=None):
    """The whole prompt in one forward: returns (logits [B, V] f32 at
    the last prompt position, a new cache of `max_len` rows filled for
    positions < Tp). `logits_index` picks another position: a scalar
    for every row, or [B] per row (a bucket of padded prompts, each
    read at its own last position)."""
    dev = _device_of(params)
    prompt = torch.as_tensor(prompt, device=dev)
    b, tp = prompt.shape
    if tp > max_len:
        raise ValueError(f"prompt of {tp} tokens does not fit a cache of {max_len}")
    x = params["embed"]["embedding"][prompt.long()].to(cfg.dtype)  # [B, Tp, d]
    tables = rope_tables(torch.arange(tp, device=dev), cfg.head_dim)
    cache = init_cache(cfg, b, max_len, device=dev)

    def attn_fn(q, k, v):
        # GQA: the kernel reads kv head h // G for query head h, the
        # mapping of JAX's repeat, without the copy
        return flash_attention(q, k, v, causal=True)

    for i in range(cfg.n_layers):
        x, k, v = _apply_block(params[f"block_{i}"], cfg, x, tables, attn_fn)
        lay = cache[f"block_{i}"]
        kh, vh = k.transpose(1, 2), v.transpose(1, 2)  # [B, KV, Tp, D]: cache layout
        if cfg.kv_quant:
            kq, ks = _kv_quantize(kh)
            vq, vs = _kv_quantize(vh)
            lay["k_q"][:, :, :tp] = kq
            lay["k_s"][:, :, 0, :tp] = ks[..., 0]
            lay["v_q"][:, :, :tp] = vq
            lay["v_s"][:, :, 0, :tp] = vs[..., 0]
        else:
            lay["k"][:, :, :tp] = kh
            lay["v"][:, :, :tp] = vh

    if logits_index is None:
        x_last = x[:, -1:]
    else:
        idx = torch.as_tensor(logits_index, device=dev).long()
        if idx.ndim == 0:
            x_last = x.index_select(1, idx.reshape(1))
        else:
            x_last = x[torch.arange(b, device=dev), idx][:, None]
    return _head(params, cfg, x_last), cache


def _sample(logits, generator, temperature: float, top_k: Optional[int]):
    if temperature == 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_k is not None:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)
    # Gumbel-max: argmax(logits + Gumbel noise) is a draw from softmax(logits)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return (logits - torch.log(-torch.log(u))).argmax(dim=-1).to(torch.int32)


_MASK32 = 0xFFFFFFFF
# odd multipliers below 2**31: a 32-bit value times one stays under
# 2**63, so int64 tensors hold every product exactly (no overflow)
_MIX1, _MIX2 = 0x7FEB352D, 0x2C1B3C6D


def _mix32(x):
    """A 32-bit integer hash (xor-shift-multiply rounds) on int64 values
    in [0, 2**32): a Python int or an int64 tensor, the same bits."""
    x = x ^ (x >> 16)
    x = (x * _MIX1) & _MASK32
    x = x ^ (x >> 15)
    x = (x * _MIX2) & _MASK32
    return x ^ (x >> 16)


def request_uniforms(seed: int, rid, pos, vocab: int) -> torch.Tensor:
    """Uniforms in (0, 1), float32 [B, vocab]: entry (b, v) is a pure
    function of (seed, rid[b], pos[b], v). A counter-based stream like
    JAX's `fold_in(fold_in(key, rid), pos)`, made of int64 tensor
    operations on rid's device, with no host round trip."""
    key = _mix32((int(seed) ^ 0x9E3779B9) & _MASK32)
    rid = torch.as_tensor(rid).to(torch.int64) & _MASK32
    pos = torch.as_tensor(pos, device=rid.device).to(torch.int64) & _MASK32
    h = _mix32(_mix32(key ^ rid) ^ pos)  # [B]
    col = _mix32(torch.arange(vocab, dtype=torch.int64, device=rid.device) ^ 0x85EBCA6B)
    bits = _mix32(h[:, None] ^ col[None, :])  # [B, V]
    return ((bits >> 8).to(torch.float32) + 0.5) * (2.0 ** -24)


def sample_per_request(logits, seed: int, rid, pos, temperature: float,
                       top_k: Optional[int]) -> torch.Tensor:
    """The token at position pos[b] of request rid[b], from logits [B, V]:
    argmax at temperature 0, else Gumbel-max over the top_k-masked
    logits / temperature with `request_uniforms`' noise. A row's token
    depends on its own logits and (seed, rid, pos) alone, never on the
    other rows (the LM server's per-request sampling contract)."""
    if temperature == 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)
    u = request_uniforms(seed, rid, pos, logits.shape[-1])
    return (logits - torch.log(-torch.log(u))).argmax(dim=-1).to(torch.int32)


@torch.no_grad()
def generate(params, cfg: LMConfig, prompt, max_new_tokens: int, temperature: float = 0.0,
             top_k: Optional[int] = None, seed: int = 0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (temperature 0) or temperature/top-k decoding; returns
    int32 [B, max_new_tokens] on the params' device. The prompt runs
    through `prefill`; each new token is one `decode_step`. Pass
    `generator` (a torch.Generator on that device) instead of `seed` to
    continue one stream of random numbers across calls."""
    dev = _device_of(params)
    prompt = torch.as_tensor(prompt, device=dev)
    b, tp = prompt.shape
    if max_new_tokens <= 0:
        return torch.zeros((b, 0), dtype=torch.int32, device=dev)
    total = tp + max_new_tokens
    if generator is None and temperature != 0.0:
        generator = torch.Generator(device=dev).manual_seed(seed)
    logits, cache = prefill(params, cfg, prompt, total)
    cur = _sample(logits, generator, temperature, top_k)  # the token at position Tp
    out = [cur]
    # steps write positions Tp .. total-2, predicting Tp+1 .. total-1
    for t in range(tp, total - 1):
        logits, cache = decode_step(params, cfg, cache, cur, t)
        cur = _sample(logits, generator, temperature, top_k)
        out.append(cur)
    return torch.stack(out, dim=1)
