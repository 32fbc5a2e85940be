"""The path that runs the attention kernels past the main path's head
dims, held to the JAX package on the CPU (the kernels' whole domain:
tests/test_torch_head_dims.py).

- The cluster LM bench's ShardLM geometry (d 384 over 4 heads, GQA-2: D
  96; dml_tpu/inference/lm_sharded.py) and its draft_lm_spec draft (D 48)
  served in bfloat16 with speculative decoding through the port's
  `LMBackend.from_spec` and the JAX package's, from one weights file per
  model written by the JAX package's codec (`variables_to_bytes`; the
  port reads it with `variables_from_bytes` and `lm_params_from_flax`):
  equal tokens. On the CPU the port's wrappers run the kernels' plain
  versions; chip_smoke.py's phase 24 serves the same geometry through the
  kernels on the card.
- `LongContextLM.train_step` at D 96 and D 48 (float32), its state from
  the JAX init through `lm_train_state_from_flax`: the loss within 1e-5
  relative of JAX's, every gradient within atol 5e-5 + rtol 5e-4 (the
  flash gradient bar of tests/test_ops.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_tpu import config as jconfig
from dml_tpu.config import MeshSpec
from dml_tpu.inference import lm_backend as jlb
from dml_tpu.models import params_io as jpio
from dml_tpu.models.transformer import TransformerLM as JaxLM
from dml_tpu.parallel.long_context import LongContextLM as JaxLCLM
from dml_tpu.parallel.long_context import lm_loss as jax_lm_loss
from dml_tpu.parallel.mesh import make_mesh
from dml_tpu_torch.inference import lm_backend as tlb
from dml_tpu_torch.models.lm_params import lm_params_from_flax, lm_train_state_from_flax, state_dict_of
from dml_tpu_torch.parallel.long_context import LongContextLM


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the tests run beside other test processes on a shared CPU; torch's
    # default of one thread per core oversubscribes it
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# the cluster LM bench's ShardLM (dml_tpu/inference/lm_sharded.py) at its
# width, cut to 2 of its 4 layers to keep the JAX compiles short: D 96;
# draft_lm_spec's draft halves d_model and keeps the heads: D 48
SHARD = dict(vocab_size=128, d_model=384, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=1536)


def _weights_file(path, spec, seed):
    """A flax-msgpack weights file of the JAX package's init of `spec`'s LM."""
    shape = {k: spec[k] for k in ("vocab_size", "d_model", "n_heads", "n_layers", "d_ff", "n_kv_heads")}
    params = jax.jit(JaxLM(dtype=jnp.float32, **shape).init)(jax.random.PRNGKey(seed),
                                                             jnp.zeros((1, 8), jnp.int32))["params"]
    with open(path, "wb") as f:
        f.write(jpio.variables_to_bytes({"params": params}))
    return path


def test_shardlm_and_its_draft_served_in_bf16_match_jax(tmp_path):
    base = dict(SHARD, name="ShardLM", dtype="bfloat16")
    draft = jconfig.draft_lm_spec(base)
    assert base["d_model"] // base["n_heads"] == 96 and draft["d_model"] // draft["n_heads"] == 48
    spec = dict(base, weights=_weights_file(str(tmp_path / "target.msgpack"), base, 0),
                max_new_tokens=6, max_slots=2, max_len=64, chunk=3, spec_k=2, spec_min_accept=0.0,
                spec_draft={"weights": _weights_file(str(tmp_path / "draft.msgpack"), draft, 1)})
    rng = np.random.RandomState(7)
    paths = []
    for i, n in enumerate((5, 11, 8)):
        paths.append(str(tmp_path / f"p{i}.tokens.txt"))
        jlb.write_prompt_file(paths[-1], rng.randint(0, 128, n))
    results, stats = [], []
    for mod, kw in ((tlb, dict(device="cpu")), (jlb, {})):
        be = mod.LMBackend.from_spec(spec, **kw)
        try:
            res, _, _ = be.serve_files(paths)
            stats.append(be.spec_stats())
        finally:
            be.close()
        results.append({p: r["tokens"] for p, r in res.items()})
    assert results[0] == results[1]
    assert all(len(t) == 6 for t in results[0].values())
    assert stats[0]["enabled"] and stats[0]["rounds"] > 0  # the D-48 draft ran


def _mesh():
    return make_mesh(MeshSpec(dp=1), devices=jax.devices()[:1])


@pytest.mark.parametrize("d_model", [192, 96], ids=["D96", "D48"])
def test_long_context_train_step_at_head_dim_matches_jax(d_model):
    cfg = dict(vocab_size=128, d_model=d_model, n_heads=2, n_kv_heads=1, n_layers=1, d_ff=256)
    seq = 64
    jlm = JaxLCLM(_mesh(), seq_len=seq, dtype=jnp.float32, **cfg)
    lm = LongContextLM(seq_len=seq, dtype=torch.float32, device="cpu", **cfg)
    lm.state = lm_train_state_from_flax(jax.tree_util.tree_map(np.asarray, jax.device_get(jlm.state)),
                                        device="cpu")
    toks = np.random.RandomState(d_model).randint(0, 128, (2, seq)).astype(np.int32)

    def loss_fn(params):
        return jax_lm_loss(jlm.model.apply({"params": params}, jnp.asarray(toks)), jnp.asarray(toks))

    with jlm.mesh:
        j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(jlm.state["params"])
    # train_step returns the loss before its AdamW step and leaves the
    # step's gradients on the parameters
    loss = lm.train_step(toks)
    assert abs(loss - float(j_loss)) <= 1e-5 * abs(float(j_loss)) and lm.step == 1
    want = state_dict_of(lm_params_from_flax(jax.tree_util.tree_map(np.asarray, j_grads), device="cpu"))
    for name, p in lm.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=5e-5, rtol=5e-4,
                                   err_msg=name)
