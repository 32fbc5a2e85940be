"""The port's flash attention backward against the JAX package's, on the CPU.

`jax.grad` through JAX's `flash_attention` / `flash_attention_lse` (its
Pallas forward and backward kernels in interpret mode, 32-row blocks, so
several q and k blocks, the causal block skip and the padded rows are
exercised) against torch autograd through the port's, whose
autograd Function runs the plain `attention_backward` on a CPU tensor.
The loss is sum(sin(out)) (+ sum(cos(lse)) for the lse variant), as in
tests/test_ops.py; the same numpy-seeded inputs go to both.

Tolerances: float32 at the JAX package's own gradient bar, atol 5e-5 and
rtol 5e-4 (tests/test_ops.py). bfloat16 within 1e-2 of the largest
reference magnitude: both sides round P, dS and the gradients to bf16 at
the same places, and their float32 sums differ in order, so a result may
land one bf16 ulp (2^-8 relative) away.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_tpu.ops.flash_attention import flash_attention as jax_flash
from dml_tpu.ops.flash_attention import flash_attention_lse as jax_flash_lse
from dml_tpu_torch.ops import flash_attention as fa

BLOCK = 32
BF16_REL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the tests run beside other test processes on a shared CPU; torch's
    # default of one thread per core oversubscribes it
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _qkv(b, tq, tk, h, d, seed, kv=None):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, tk, kv or h, d)).astype(np.float32)
    v = rng.standard_normal((b, tk, kv or h, d)).astype(np.float32)
    return q, k, v


def _jax_grads(q, k, v, causal, dtype, with_lse):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def loss(q, k, v):
        if with_lse:
            o, lse = jax_flash_lse(q, k, v, causal=causal, block_q=BLOCK, block_k=BLOCK,
                                   interpret=True)
            return jnp.sum(jnp.sin(o.astype(jnp.float32))) + jnp.sum(jnp.cos(lse))
        o = jax_flash(q, k, v, causal=causal, block_q=BLOCK, block_k=BLOCK, interpret=True)
        return jnp.sum(jnp.sin(o.astype(jnp.float32)))

    grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x, jdt) for x in (q, k, v)))
    return [np.asarray(g, np.float32) for g in grads]


def _torch_grads(q, k, v, causal, dtype, with_lse):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    if with_lse:
        o, lse = fa.flash_attention_lse(*ts, causal=causal)
        loss = o.float().sin().sum() + lse.cos().sum()
    else:
        loss = fa.flash_attention(*ts, causal=causal).float().sin().sum()
    loss.backward()
    return ts


CASES = [
    # (b, tq, tk, h, d, causal, with_lse)
    pytest.param(1, 96, 96, 2, 32, True, False, id="causal"),
    pytest.param(1, 96, 96, 2, 32, False, False, id="noncausal"),
    pytest.param(1, 100, 100, 2, 16, True, False, id="causal-padded-T100"),
    pytest.param(2, 64, 192, 2, 32, False, False, id="cross-Tq64-Tk192"),
    pytest.param(1, 64, 64, 2, 32, False, True, id="lse-cotangent"),
    pytest.param(1, 100, 100, 2, 16, True, True, id="lse-cotangent-causal-padded"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,tq,tk,h,d,causal,with_lse", CASES)
def test_backward_matches_jax_kernels(b, tq, tk, h, d, causal, with_lse, dtype):
    q, k, v = _qkv(b, tq, tk, h, d, seed=tq + tk + 3 * with_lse)
    want = _jax_grads(q, k, v, causal, dtype, with_lse)
    before = (fa.flash_launches, fa.flash_bwd_launches)
    got = _torch_grads(q, k, v, causal, dtype, with_lse)
    assert (fa.flash_launches, fa.flash_bwd_launches) == before  # CPU tensors: plain versions
    for t, ref, name in zip(got, want, "qkv"):
        assert t.grad.dtype == dtype and t.grad.shape == t.shape, name
        g = t.grad.float().numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(g, ref, atol=5e-5, rtol=5e-4, err_msg=f"d{name}")
        else:
            np.testing.assert_allclose(g, ref, atol=BF16_REL * np.abs(ref).max(), rtol=0,
                                       err_msg=f"d{name}")


def test_grouped_kv_gradients_equal_the_repeated_form():
    # k/v with KV < H heads: their gradients are the sums over each
    # group of what the repeated (full-head) form gets, the repeat's VJP
    q, k, v = _qkv(2, 48, 48, 4, 16, seed=5, kv=2)
    for causal, with_lse in ((True, False), (False, True)):
        grouped = _torch_grads(q, k, v, causal, torch.float32, with_lse)
        ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        kr, vr = (t.repeat_interleave(2, dim=2) for t in ts[1:])
        if with_lse:
            o, lse = fa.flash_attention_lse(ts[0], kr, vr, causal=causal)
            loss = o.sin().sum() + lse.cos().sum()
        else:
            loss = fa.flash_attention(ts[0], kr, vr, causal=causal).sin().sum()
        loss.backward()
        for a, b, name in zip(grouped, ts, "qkv"):
            np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-6, rtol=1e-5,
                                       err_msg=f"d{name}")
    # the plain backward called directly: the same gradients, and dlse=None
    # is the no-lse-cotangent case
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = fa.attention_with_lse(qt, kt, vt, causal=True)
    dout = torch.from_numpy(np.random.RandomState(6).standard_normal(out.shape).astype(np.float32))
    dq, dk, dv = fa.flash_attention_backward(qt, kt, vt, out, lse, dout, causal=True)
    assert dk.shape == kt.shape and dv.shape == vt.shape
    ts = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    (fa.flash_attention(*ts, causal=True) * dout).sum().backward()
    for a, b in zip((dq, dk, dv), ts):
        np.testing.assert_allclose(a.numpy(), b.grad.numpy(), atol=1e-6, rtol=1e-5)


def test_no_grad_calls_keep_the_forward_path_and_counts():
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(1, 32, 32, 2, 16, seed=7))
    before = (fa.flash_launches, fa.flash_bwd_launches)
    with torch.no_grad():
        out, lse = fa.flash_attention_lse(q, k, v, causal=True)
    assert out.grad_fn is None and lse.grad_fn is None
    assert (fa.flash_launches, fa.flash_bwd_launches) == before
    want = fa.attention_with_lse(q.detach(), k.detach(), v.detach(), causal=True)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    # with grad, the same forward values through the autograd Function
    out_g = fa.flash_attention(q, k, v, causal=True)
    assert out_g.grad_fn is not None and torch.equal(out_g.detach(), out)
    # neither CPU nor CUDA: the backward wrapper raises, it never takes the plain version
    m = q.detach().to("meta")
    with pytest.raises(RuntimeError, match="no flash attention kernel"):
        fa.flash_attention_backward(m, m, m, m, lse.to("meta"), m, causal=True)
