"""The path that runs the attention kernels past head dim 256, held to the
JAX package on the CPU (the kernels themselves: tests/test_torch_wide_
heads.py).

A wide-head LM: d_model 640 over 2 query heads on 1 kv head (D 320), 2
blocks, vocab 128, the JAX package's initialisation carried over with
`lm_params_from_flax`. chip_smoke.py's phase 25 drives the same
regrouping at the 198M LM's widths (d_model 1024 over 2 heads on 1: D
512) through `LMBackend.from_spec` and `LongContextLM` on the card.

- Prefill logits within the JAX package's bar for them (2e-4,
  tests/test_torch_generate.py) and greedy float32 tokens equal to JAX's
  `generate`.
- `LongContextLM.train_step` in float32: the loss and every gradient
  within 1e-4 of JAX's (its state from the JAX init through
  `lm_train_state_from_flax`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_tpu.config import MeshSpec
from dml_tpu.inference import generate as jg
from dml_tpu.models.transformer import TransformerLM as JaxLM
from dml_tpu.parallel.long_context import LongContextLM as JaxLCLM
from dml_tpu.parallel.long_context import lm_loss as jax_lm_loss
from dml_tpu.parallel.mesh import make_mesh
from dml_tpu_torch.inference import generate as tg
from dml_tpu_torch.models.lm_params import lm_params_from_flax, lm_train_state_from_flax, state_dict_of
from dml_tpu_torch.ops import decode_attention as da
from dml_tpu_torch.ops import flash_attention as fa
from dml_tpu_torch.parallel.long_context import LongContextLM

WIDE = dict(vocab_size=128, d_model=640, n_heads=2, n_kv_heads=1, n_layers=2, d_ff=512)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the tests run beside other test processes on a shared CPU; torch's
    # default of one thread per core oversubscribes it
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jp = jax.jit(JaxLM(dtype=jnp.float32, **WIDE).init)(jax.random.PRNGKey(0),
                                                        jnp.zeros((1, 8), jnp.int32))["params"]
    return jp, lm_params_from_flax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def test_wide_head_lm_prefill_and_greedy_tokens_match_jax(params):
    assert WIDE["d_model"] // WIDE["n_heads"] == 320
    jp, tp_ = params
    jcfg, tcfg = jg.LMConfig(dtype=jnp.float32, **WIDE), tg.LMConfig(dtype=torch.float32, **WIDE)
    prompt = np.random.RandomState(320).randint(0, WIDE["vocab_size"], (2, 11)).astype(np.int32)
    j_logits, _ = jg.prefill(jp, jcfg, jnp.asarray(prompt), 24)
    before = (fa.flash_launches, da.decode_launches)
    logits, _ = tg.prefill(tp_, tcfg, torch.from_numpy(prompt), 24)
    assert logits.shape == (2, WIDE["vocab_size"])
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=2e-4)
    want = np.asarray(jg.generate(jp, jcfg, jnp.asarray(prompt), max_new_tokens=8))
    got = tg.generate(tg.serving_params(tp_, tcfg), tcfg, torch.from_numpy(prompt), 8)
    assert (fa.flash_launches, da.decode_launches) == before  # CPU tensors: the plain versions
    np.testing.assert_array_equal(got.numpy(), want)


def test_wide_head_long_context_train_step_matches_jax():
    seq = 64
    mesh = make_mesh(MeshSpec(dp=1), devices=jax.devices()[:1])
    jlm = JaxLCLM(mesh, seq_len=seq, dtype=jnp.float32, **WIDE)
    lm = LongContextLM(seq_len=seq, dtype=torch.float32, device="cpu", **WIDE)
    lm.state = lm_train_state_from_flax(jax.tree_util.tree_map(np.asarray, jax.device_get(jlm.state)),
                                        device="cpu")
    toks = np.random.RandomState(640).randint(0, WIDE["vocab_size"], (2, seq)).astype(np.int32)

    def loss_fn(p):
        return jax_lm_loss(jlm.model.apply({"params": p}, jnp.asarray(toks)), jnp.asarray(toks))

    with jlm.mesh:
        j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(jlm.state["params"])
    # train_step returns the loss before its AdamW step and leaves the
    # step's gradients on the parameters
    loss = lm.train_step(toks)
    assert abs(loss - float(j_loss)) <= 1e-4 and lm.step == 1
    want = state_dict_of(lm_params_from_flax(jax.tree_util.tree_map(np.asarray, j_grads), device="cpu"))
    for name, p in lm.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=1e-4, err_msg=name)
