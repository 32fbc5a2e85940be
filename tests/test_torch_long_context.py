"""The port's LongContextLM (training on one device) against the JAX
package's, on the CPU.

The JAX side is `dml_tpu.parallel.long_context.LongContextLM` on a
one-device mesh (its flash kernels in interpret mode, as the JAX
package's tests run them off the TPU); the port's runs on
`device="cpu"`, its attention the flash autograd Function with the plain
forward and backward. Weights come from the JAX init and cross through
`lm_train_state_from_flax`. Config: vocab 128, d_model 64, 4 heads, 2 KV
heads, 2 layers, d_ff 128, seq 64, B=2.

Tolerances, float32 (the same math in another summation order): step-1
loss within 1e-5 relative; every parameter's step-1 gradient within
atol 5e-5, rtol 5e-4 (the flash gradient bar of tests/test_ops.py);
four steps' losses within 1e-4 relative (AdamW's first steps move each
parameter by about lr * sign(g), so a gradient within a rounding of 0
can flip its update: the bar leaves room for those few). bfloat16:
step-1 loss within 1e-2 relative (XLA fuses the compiled step's bf16
elementwise ops and drops roundings eager PyTorch makes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_tpu.config import MeshSpec
from dml_tpu.parallel.long_context import LongContextLM as JaxLCLM
from dml_tpu.parallel.long_context import lm_loss as jax_lm_loss
from dml_tpu.parallel.mesh import make_mesh
from dml_tpu_torch.inference import generate as gen
from dml_tpu_torch.models.lm_params import (
    lm_params_from_flax, lm_train_state_from_flax, params_tree_of, state_dict_of,
)
from dml_tpu_torch.ops import flash_attention as fa
from dml_tpu_torch.parallel.long_context import LongContextLM, lm_loss, make_lm

CFG = dict(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=128)
SEQ, BATCH = 64, 2


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the tests run beside other test processes on a shared CPU; torch's
    # default of one thread per core oversubscribes it
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _mesh():
    # one device of the tests' 8 virtual CPU devices (local_mesh(dp=1)
    # would have to cover all of them)
    return make_mesh(MeshSpec(dp=1), devices=jax.devices()[:1])


def _tokens(seed=0):
    return np.random.RandomState(seed).randint(0, CFG["vocab_size"], (BATCH, SEQ)).astype(np.int32)


def _host(state):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(state))


def _pair(dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jlm = JaxLCLM(_mesh(), seq_len=SEQ, dtype=jdt, **CFG)
    lm = LongContextLM(seq_len=SEQ, dtype=dtype, device="cpu", **CFG)
    lm.state = lm_train_state_from_flax(_host(jlm.state), device="cpu")
    return jlm, lm


def test_float32_train_steps_match_jax():
    jlm, lm = _pair(torch.float32)
    toks = _tokens()
    mesh = jlm.mesh

    def loss_fn(params):
        return jax_lm_loss(jlm.model.apply({"params": params}, jnp.asarray(toks)), jnp.asarray(toks))

    with mesh:
        j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(jlm.state["params"])
    loss = lm.loss(toks)
    loss.backward()
    assert abs(float(loss.detach()) - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    want = state_dict_of(lm_params_from_flax(_host(j_grads), device="cpu"))
    for name, p in lm.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=5e-5, rtol=5e-4,
                                   err_msg=name)
    lm.model.zero_grad(set_to_none=True)
    j_losses = [jlm.train_step(toks) for _ in range(4)]
    losses = [lm.train_step(toks) for _ in range(4)]
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    assert losses[-1] < losses[0] and lm.step == 4

    # after two more JAX steps, the converted state (params, mu, nu,
    # count) continues with JAX's losses
    j_more = [jlm.train_step(toks) for _ in range(2)]
    lm.state = lm_train_state_from_flax(_host(jlm.state), device="cpu")
    assert lm.step == 6 and lm.state["opt_state"]["count"] == 6
    j_next = [jlm.train_step(toks) for _ in range(2)]
    np.testing.assert_allclose([lm.train_step(toks) for _ in range(2)], j_next, rtol=1e-4)
    assert j_next[0] < j_more[0]


def test_bfloat16_loss_lm_loss_and_entry_points(monkeypatch):
    jlm, lm = _pair(torch.bfloat16)
    toks = _tokens(1)
    j_first = jlm.train_step(toks)
    first = lm.train_step(toks)
    assert abs(first - j_first) <= 1e-2 * abs(j_first)
    # lm_loss on the same logits
    logits = np.random.RandomState(2).standard_normal((BATCH, SEQ, CFG["vocab_size"]))
    logits = logits.astype(np.float32)
    np.testing.assert_allclose(float(lm_loss(torch.from_numpy(logits), torch.from_numpy(toks))),
                               float(jax_lm_loss(jnp.asarray(logits), jnp.asarray(toks))),
                               rtol=1e-6)
    # the forward's logits are the model's, without grad
    out = lm.forward(toks)
    assert out.dtype == torch.float32 and out.shape == (BATCH, SEQ, CFG["vocab_size"])
    assert out.grad_fn is None
    # make_lm: seq_parallel validated whatever the mesh; one device only
    with pytest.raises(ValueError, match="seq_parallel"):
        make_lm(None, seq_parallel="rings", **CFG)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        make_lm({"dp": 1, "sp": 2}, **CFG)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        LongContextLM(make_mesh(MeshSpec(dp=2), devices=jax.devices()[:2]), seq_len=SEQ,
                      device="cpu", **CFG)
    assert make_lm(_mesh(), seq_parallel="ulysses", **CFG).block_0.attention is fa.flash_attention
    with pytest.raises(NotImplementedError, match="MoE"):
        LongContextLM(seq_len=SEQ, device="cpu", num_experts=4, **CFG)
    # cuda by default, and it raises without a card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LongContextLM(seq_len=SEQ, **CFG)


def test_generate_serves_the_trained_weights():
    lm = LongContextLM(seq_len=SEQ, dtype=torch.float32, device="cpu", seed=3, **CFG)
    toks = _tokens(4)
    for _ in range(2):
        lm.train_step(toks)
    prompt = toks[:, :16]
    cfg = gen.LMConfig(**CFG, dtype=torch.float32)
    params = gen.serving_params(params_tree_of(lm.model.state_dict()), cfg)
    want = gen.generate(params, cfg, torch.from_numpy(prompt), 8).numpy()
    got = lm.generate(prompt, 8)
    assert got.dtype == np.int32 and got.shape == (BATCH, 8)
    np.testing.assert_array_equal(got, want)
    # bf16 serving form: block kernels cast once, cached per training step
    lm16 = LongContextLM(seq_len=SEQ, dtype=torch.bfloat16, device="cpu", seed=3, **CFG)
    lm16.train_step(toks)
    first = lm16._serving_params(quantized=False, cast=True)
    assert first["block_0"]["qkv"]["kernel"].dtype == torch.bfloat16
    assert lm16._serving_params(quantized=False, cast=True) is first
    cfg16 = gen.LMConfig(**CFG, dtype=torch.bfloat16)
    np.testing.assert_array_equal(lm16.generate(prompt, 8),
                                  gen.generate(first, cfg16, torch.from_numpy(prompt), 8).numpy())
    lm16.train_step(toks)
    assert lm16._serving_params(quantized=False, cast=True) is not first
    q8 = lm16.generate(prompt, 4, quantize_weights=True, kv_quant=True)
    assert q8.shape == (BATCH, 4) and 0 <= q8.min() and q8.max() < CFG["vocab_size"]



def test_bfloat16_cast_form_matches_jax():
    """The bf16 serving form rounds every leaf with ndim >= 2 (lm_head and
    embedding included) as the JAX package's does: the same prefill
    logits, bit for bit up to 1e-6, and the same greedy tokens."""
    from dml_tpu.inference import generate as jax_gen

    jlm, lm = _pair(torch.bfloat16)
    prompt = np.random.RandomState(4).randint(0, CFG["vocab_size"], (2, 16)).astype(np.int32)
    jparams = jlm._serving_params(quantized=False, cast=True)
    params = lm._serving_params(quantized=False, cast=True)
    for name in ("lm_head", "embed"):
        for leaf in params[name].values():
            assert leaf.dtype == torch.bfloat16, name
    assert params["ln_out"]["scale"].dtype == torch.float32
    j_logits, _ = jax_gen.prefill(jparams, jax_gen.LMConfig(**CFG, dtype=jnp.bfloat16),
                                  jnp.asarray(prompt), 24)
    logits, _ = gen.prefill(params, lm.cfg, torch.from_numpy(prompt), 24)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(lm.generate(prompt, 8), jlm.generate(prompt, 8))
