"""The float32 flash kernels' arithmetic, split TF32, held to the JAX
package's kernels on the CPU before any card runs it.

The port's float32 attention kernels (K2's forward, K3's dq and dkv pair,
at every head dim: csrc/flash_attention.cu, csrc/flash_attention_bwd_tf32.cu)
form every product on the tensor cores in split TF32 (csrc/hopper.cuh):
x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), rounded as
`cvt.rna.tf32.f32` rounds (add 0x1000 to the bits, clear the low 13), and
a b as hi_a lo_b + lo_a hi_b + hi_a hi_b, three TF32 products (each exact
in float32) summed in float32. A CUDA kernel cannot run here, so this file
emulates that arithmetic in plain torch (S, dP, P V, dS K, P^T dO and
dS^T Q each as the three products) around the kernels' own softmax and
recomputation, and holds it to `dml_tpu/ops/flash_attention.py`'s forward
and VJP in interpret mode, as tests/test_ops.py runs them, at the JAX
package's float32 bars: out and lse within 2e-5, dq, dk and dv within
atol 5e-5 + rtol 5e-4. The cases: the cluster LM bench's ShardLM (D 96,
GQA-2, T 300), its draft's D 48, a D-80 target's draft's D 40 and the
chunked route's D 512, causal and full. The one-pass form, tf32(a)
tf32(b), falls outside the forward bar at D 96: that is why the kernels
split. The emulation's sums round to nearest; the tensor cores' own sums
align their addends by truncation, an error that grows along a long chain
into one accumulator, so the backward sums each column tile's products
over a step from zero and adds them to dQ, dK and dV in float32
(hopper.cuh::product_cb), and the card runs
hold the kernels themselves to the plain version (chip_smoke.py, phases 6
and 9, T up to 1000 over 4 query heads a kv head).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_tpu.ops.flash_attention import flash_attention_lse as jax_flash_lse

BLOCK = 64  # the JAX kernels' blocks


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the tests run beside other test processes on a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds it: to nearest, ties
    away from zero (the bits plus 0x1000, the low 13 cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels form it: hi lo + lo hi + hi hi, in float32."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return ah @ bl + al @ bh + ah @ bh


def one_pass_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 product, what the tensor cores give unsplit."""
    return tf32(a) @ tf32(b)


def _heads(x, h):
    """[B, T, KV, D] -> [B, H, T, D], kv head j serving query heads
    j H / KV .. (j + 1) H / KV - 1, as the kernels read it."""
    return x.repeat_interleave(h // x.shape[2], dim=2).transpose(1, 2)


def _mask(s, causal):
    if not causal:
        return s
    tq, tk = s.shape[-2:]
    keep = torch.arange(tq)[:, None] >= torch.arange(tk)[None, :]
    return torch.where(keep, s, torch.full_like(s, -1e30))


def emulated_forward(q, k, v, causal, mm):
    """K2's float32 arithmetic with products `mm`: S = Q K^T scale, the
    softmax in float32 (exp, row sums of the unrounded P), O = P V / l,
    lse = m + log l. q [B, Tq, H, D], k/v [B, Tk, KV, D] -> (out [B, Tq,
    H, D], lse [B, H, Tq])."""
    h, d = q.shape[2], q.shape[3]
    s = _mask(mm(q.transpose(1, 2), _heads(k, h).transpose(-1, -2)) * d ** -0.5, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    rowsum = p.sum(-1, keepdim=True)
    out = mm(p, _heads(v, h)) / rowsum
    return out.transpose(1, 2), (m + torch.log(rowsum))[..., 0]


def emulated_backward(q, k, v, out, lse, dout, dlse, causal, mm):
    """K3's float32 arithmetic with products `mm`, by recomputation from
    lse: P = exp(S - lse), dP = dO V^T, dS = P (dP - delta') scale with
    delta' = rowsum(dO O) - g_lse (the delta kernel's float32 FMAs); dV =
    P^T dO, dK = dS^T Q, dQ = dS K, a kv head's gradients summed over its
    query heads."""
    b, tk, kv, d = k.shape
    h = q.shape[2]
    scale = d ** -0.5
    qh, doh = q.transpose(1, 2), dout.transpose(1, 2)
    kh, vh = _heads(k, h), _heads(v, h)
    p = torch.exp(_mask(mm(qh, kh.transpose(-1, -2)) * scale, causal) - lse[..., None])
    dp = mm(doh, vh.transpose(-1, -2))
    delta = (dout * out).sum(-1).transpose(1, 2) - dlse
    ds = p * (dp - delta[..., None]) * scale
    dv = mm(p.transpose(-1, -2), doh)
    dk = mm(ds.transpose(-1, -2), qh)
    dq = mm(ds, kh)
    dk = dk.reshape(b, kv, h // kv, tk, d).sum(2).transpose(1, 2)
    dv = dv.reshape(b, kv, h // kv, tk, d).sum(2).transpose(1, 2)
    return dq.transpose(1, 2), dk, dv


# name, b, t, h, kv, d: ShardLM (d_model 384 over 4 heads, GQA-2) at a
# 300-token prefill, its draft's D 48, a D-80 target's draft (D 40), and
# the wide-head LM's D 512 (the chunked route) at a short T
CASES = [
    pytest.param(2, 300, 4, 2, 96, id="shardlm_d96"),
    pytest.param(2, 128, 4, 2, 48, id="draft_d48"),
    pytest.param(1, 128, 4, 4, 40, id="draft_d40"),
    pytest.param(1, 64, 2, 1, 512, id="wide_d512"),
]
CAUSAL = [pytest.param(True, id="causal"), pytest.param(False, id="full")]


def _inputs(b, t, h, kv, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((b, t, h, d)).astype(np.float32),
            rng.standard_normal((b, t, kv, d)).astype(np.float32),
            rng.standard_normal((b, t, kv, d)).astype(np.float32))


def _jax_forward(q, k, v, causal):
    h, kv = q.shape[2], k.shape[2]
    return jax_flash_lse(jnp.asarray(q), jnp.repeat(jnp.asarray(k), h // kv, axis=2),
                         jnp.repeat(jnp.asarray(v), h // kv, axis=2), causal=causal,
                         block_q=BLOCK, block_k=BLOCK, interpret=True)


@pytest.mark.parametrize("causal", CAUSAL)
@pytest.mark.parametrize("b,t,h,kv,d", CASES)
def test_split_tf32_forward_within_jax_float32_bars(b, t, h, kv, d, causal):
    q, k, v = _inputs(b, t, h, kv, d, seed=d + t)
    j_out, j_lse = _jax_forward(q, k, v, causal)
    out, lse = emulated_forward(*(torch.from_numpy(x) for x in (q, k, v)), causal, split_matmul)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=2e-5, rtol=0)


@pytest.mark.parametrize("causal", CAUSAL)
@pytest.mark.parametrize("b,t,h,kv,d", CASES)
def test_split_tf32_backward_within_jax_float32_bars(b, t, h, kv, d, causal):
    q, k, v = _inputs(b, t, h, kv, d, seed=1000 + d + t)

    def loss(q, k, v):  # k and v repeated inside: their gradients sum over each group
        o, lse = jax_flash_lse(q, jnp.repeat(k, h // kv, axis=2), jnp.repeat(v, h // kv, axis=2),
                               causal=causal, block_q=BLOCK, block_k=BLOCK, interpret=True)
        return jnp.sum(jnp.sin(o)) + jnp.sum(jnp.cos(lse))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = emulated_forward(tq, tk, tv, causal, split_matmul)
    # the loss's cotangents: d sin(o) = cos(o), d cos(lse) = -sin(lse)
    got = emulated_backward(tq, tk, tv, out, lse, torch.cos(out), -torch.sin(lse), causal, split_matmul)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5, rtol=5e-4, err_msg=name)


def test_one_pass_tf32_falls_outside_the_forward_bar_at_d96():
    # tf32(a) tf32(b) loses ~2^-11 of each product: S and lse are off by
    # ~1e-4 at ShardLM's D 96, past the 2e-5 that the split keeps
    q, k, v = _inputs(2, 300, 4, 2, 96, seed=396)
    j_out, j_lse = _jax_forward(q, k, v, True)
    out, lse = emulated_forward(*(torch.from_numpy(x) for x in (q, k, v)), True, one_pass_matmul)
    err = max(np.abs(out.numpy() - np.asarray(j_out)).max(), np.abs(lse.numpy() - np.asarray(j_lse)).max())
    assert err > 2e-5
    s_out, s_lse = emulated_forward(*(torch.from_numpy(x) for x in (q, k, v)), True, split_matmul)
    split_err = max(np.abs(s_out.numpy() - np.asarray(j_out)).max(),
                    np.abs(s_lse.numpy() - np.asarray(j_lse)).max())
    assert split_err <= 2e-5 < err
