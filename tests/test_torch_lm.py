"""The port's transformer LM, int8 weight quantization and LM weights
against the JAX package, on the CPU.

- `rope` in both position forms ([T] shared, [B, T] per slot) within
  1e-6 (float32 elementwise math on the same inputs);
- `TransformerLM` forward on JAX-initialised weights, converted by
  `lm_params_from_flax`, within 2e-4 of `TransformerLM.apply` (float32;
  the bar of tests/test_generate.py), for MHA and GQA;
- `quantize_lm_params`: int8 values and scales equal to JAX's bit for
  bit, `kernel_of` and `quantized_bytes` equal;
- weight conversion and seeded init: exact copies, key and shape checks,
  Flax's distributions, and `cuda` by default; for mixture-of-experts
  trees too (block-by-block layout checks, Flax's fan-in of a stacked
  expert tensor, int8 per (expert, channel) equal to JAX's bit for bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_tpu.inference.quantize import kernel_of as jax_kernel_of
from dml_tpu.inference.quantize import quantize_lm_params as jax_quantize
from dml_tpu.inference.quantize import quantized_bytes as jax_quantized_bytes
from dml_tpu.models.transformer import TransformerLM as JaxLM
from dml_tpu.models.transformer import rope as jax_rope
from dml_tpu_torch.inference import quantize as tq
from dml_tpu_torch.inference.generate import LMConfig
from dml_tpu_torch.models import lm_params
from dml_tpu_torch.models.transformer import TransformerLM, rope

VOCAB, D_MODEL, N_HEADS, N_LAYERS, D_FF = 61, 32, 4, 2, 64


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the tests run beside other test processes on a shared CPU; torch's
    # default of one thread per core oversubscribes it
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_params(n_kv, seed=0):
    model = JaxLM(vocab_size=VOCAB, d_model=D_MODEL, n_heads=N_HEADS, n_layers=N_LAYERS,
                  d_ff=D_FF, dtype=jnp.float32, n_kv_heads=n_kv)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _cfg(n_kv=None):
    return LMConfig(VOCAB, D_MODEL, N_HEADS, N_LAYERS, D_FF, dtype=torch.float32, n_kv_heads=n_kv)


@pytest.mark.parametrize("per_slot", [False, True], ids=["shared-positions", "per-slot-positions"])
def test_rope_matches_jax(per_slot):
    rng = np.random.RandomState(3)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    pos = (rng.randint(0, 500, (2, 5)) if per_slot else np.arange(5) + 7).astype(np.int32)
    got = rope(torch.from_numpy(x), torch.from_numpy(pos))
    want = jax_rope(jnp.asarray(x), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # bf16 in, bf16 out (the math in float32, one rounding)
    got16 = rope(torch.from_numpy(x).bfloat16(), torch.from_numpy(pos))
    want16 = jax_rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos))
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), np.asarray(want16, np.float32), atol=1e-2)


@pytest.mark.parametrize("n_kv", [None, 2], ids=["mha", "gqa2"])
def test_transformer_lm_forward_matches_jax(n_kv):
    model, params = _jax_params(n_kv)
    tokens = np.random.RandomState(1).randint(0, VOCAB, (2, 9)).astype(np.int32)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(tokens)))
    lm = TransformerLM(VOCAB, D_MODEL, N_HEADS, N_LAYERS, D_FF, dtype=torch.float32,
                       n_kv_heads=n_kv)
    tree = lm_params.lm_params_from_flax(params, device="cpu", cfg=_cfg(n_kv))
    lm.load_state_dict(lm_params.state_dict_of(tree))
    with torch.no_grad():
        got = lm(torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == (2, 9, VOCAB)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def test_quantize_matches_jax_bit_for_bit():
    _, params = _jax_params(2)
    jq = jax.tree_util.tree_map(np.asarray, jax_quantize(jax.tree_util.tree_map(jnp.asarray, params)))
    tree = lm_params.lm_params_from_flax(params, device="cpu")
    pq = tq.quantize_lm_params(tree)
    for name in ["lm_head"] + [f"block_{i}" for i in range(N_LAYERS)]:
        nodes = [("lm_head", pq["lm_head"], jq["lm_head"])] if name == "lm_head" else [
            (f"{name}/{k}", pq[name][k], jq[name][k]) for k in ("qkv", "proj", "up", "down")]
        for key, mine, theirs in nodes:
            assert tq.is_quantized(mine["kernel"]), key
            assert mine["kernel"]["q"].dtype == torch.int8, key
            np.testing.assert_array_equal(mine["kernel"]["q"].numpy(), theirs["kernel"]["q"], key)
            np.testing.assert_array_equal(mine["kernel"]["scale"].numpy(), theirs["kernel"]["scale"],
                                          key)
            np.testing.assert_array_equal(
                tq.kernel_of(mine, torch.float32).numpy(),
                np.asarray(jax_kernel_of(jax.tree_util.tree_map(jnp.asarray, theirs), jnp.float32)),
                key)
    # embeddings and norms stay float; the converter takes the quantized tree too
    assert not tq.is_quantized(pq["embed"]["embedding"])
    again = lm_params.lm_params_from_flax(jq, device="cpu", cfg=_cfg(2))
    assert torch.equal(again["block_1"]["up"]["kernel"]["q"], pq["block_1"]["up"]["kernel"]["q"])
    assert tq.quantized_bytes(pq) == jax_quantized_bytes(jq)
    assert tq.kernel_of(tree["block_0"]["qkv"], torch.float32) is tree["block_0"]["qkv"]["kernel"]


def test_weight_conversion_and_seeded_init(monkeypatch):
    _, params = _jax_params(None)
    tree = lm_params.lm_params_from_flax(params, device="cpu", cfg=_cfg())
    for key in ("embed/embedding", "block_1/qkv/kernel", "block_0/ln_mlp/scale", "lm_head/kernel"):
        a, *path = key.split("/")
        got, want = tree[a], params[a]
        for p in path:
            got, want = got[p], want[p]
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    # a missing key, an extra key and a wrong shape are refused
    bad = jax.tree_util.tree_map(lambda x: x, params)
    del bad["block_1"]["up"]
    with pytest.raises(KeyError, match="block_1/up/kernel"):
        lm_params.lm_params_from_flax(bad, device="cpu")
    bad = jax.tree_util.tree_map(lambda x: x, params)
    bad["block_0"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="block_0/extra/kernel"):
        lm_params.lm_params_from_flax(bad, device="cpu", cfg=_cfg())
    with pytest.raises(ValueError, match="shape"):
        lm_params.lm_params_from_flax(params, device="cpu", cfg=_cfg(2))
    # seeded init: Flax's distributions, the same bits for the same seed
    cfg = _cfg(2)
    a = lm_params.init_lm_params(cfg, seed=5, device="cpu")
    b = lm_params.init_lm_params(cfg, seed=5, device="cpu")
    assert torch.equal(a["block_0"]["qkv"]["kernel"], b["block_0"]["qkv"]["kernel"])
    for key, shape in lm_params.lm_param_shapes(cfg).items():
        leaf = lm_params._flatten(a)[key]
        assert tuple(leaf.shape) == shape and leaf.dtype == torch.float32, key
    w = a["block_0"]["up"]["kernel"]
    std = D_MODEL ** -0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std + 1e-6  # truncated at two standard deviations
    assert abs(float(w.std()) - D_MODEL ** -0.5) < 0.15 * D_MODEL ** -0.5
    assert torch.equal(a["ln_out"]["scale"], torch.ones(D_MODEL))
    lm = TransformerLM(VOCAB, D_MODEL, N_HEADS, N_LAYERS, D_FF, dtype=torch.float32, n_kv_heads=2)
    lm.load_state_dict(lm_params.state_dict_of(a))  # keys and shapes fit the module
    # entry points default to cuda and raise without it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_params.init_lm_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_params.lm_params_from_flax(params)
    # mixture-of-experts blocks: every moe_every-th block, the seeded
    # init's keys and shapes fit them
    moe_lm = TransformerLM(VOCAB, D_MODEL, N_HEADS, 2, D_FF, num_experts=4)
    assert hasattr(moe_lm.block_1, "moe") and hasattr(moe_lm.block_0, "up")
    moe_cfg = LMConfig(VOCAB, D_MODEL, N_HEADS, 2, D_FF, dtype=torch.float32)
    moe_lm.load_state_dict(lm_params.state_dict_of(
        lm_params.init_lm_params(moe_cfg, seed=1, device="cpu", num_experts=4)))


def _jax_moe_params(seed=0):
    model = JaxLM(vocab_size=VOCAB, d_model=D_MODEL, n_heads=N_HEADS, n_layers=4, d_ff=D_FF,
                  dtype=jnp.float32, n_kv_heads=2, num_experts=4, moe_every=2)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def test_moe_quantize_matches_jax_bit_for_bit():
    params = _jax_moe_params()
    jq = jax.tree_util.tree_map(np.asarray, jax_quantize(jax.tree_util.tree_map(jnp.asarray, params)))
    pq = tq.quantize_lm_params(lm_params.lm_params_from_flax(params, device="cpu"))
    for name in ("block_1", "block_3"):
        for leaf in ("w_up", "w_down"):
            mine, theirs = pq[name]["moe"][leaf], jq[name]["moe"][leaf]
            assert mine["q"].dtype == torch.int8 and mine["scale"].shape[1] == 1  # per (expert, channel)
            np.testing.assert_array_equal(mine["q"].numpy(), theirs["q"])
            np.testing.assert_array_equal(mine["scale"].numpy(), theirs["scale"])
            np.testing.assert_array_equal(
                tq.kernel_of(mine, torch.float32).numpy(),
                np.asarray(jax_kernel_of(jax.tree_util.tree_map(jnp.asarray, theirs), jnp.float32)))
        # the router stays float
        assert not tq.is_quantized(pq[name]["moe"]["router"]["kernel"])
    assert tq.quantized_bytes(pq) == jax_quantized_bytes(jq)
    # the converter takes the quantized MoE tree, checked against cfg
    cfg = LMConfig(VOCAB, D_MODEL, N_HEADS, 4, D_FF, dtype=torch.float32, n_kv_heads=2)
    again = lm_params.lm_params_from_flax(jq, device="cpu", cfg=cfg)
    assert torch.equal(again["block_3"]["moe"]["w_down"]["q"], pq["block_3"]["moe"]["w_down"]["q"])


def test_moe_weight_conversion_and_seeded_init():
    params = _jax_moe_params()
    cfg = LMConfig(VOCAB, D_MODEL, N_HEADS, 4, D_FF, dtype=torch.float32, n_kv_heads=2)
    tree = lm_params.lm_params_from_flax(params, device="cpu", cfg=cfg)
    np.testing.assert_array_equal(tree["block_1"]["moe"]["w_up"].numpy(), params["block_1"]["moe"]["w_up"])
    assert set(tree["block_1"]) == {"ln_attn", "qkv", "proj", "ln_mlp", "moe"}
    assert set(lm_params._flatten(tree)) == set(lm_params.lm_param_shapes(cfg, num_experts=4))
    # the state dict round-trips and loads into the MoE TransformerLM
    sd = lm_params.state_dict_of(tree)
    assert sd["block_3.moe.router.kernel"].shape == (D_MODEL, 4)
    assert lm_params._flatten(lm_params.params_tree_of(sd)).keys() == lm_params._flatten(tree).keys()
    TransformerLM(VOCAB, D_MODEL, N_HEADS, 4, D_FF, dtype=torch.float32, n_kv_heads=2,
                  num_experts=4).load_state_dict(sd)
    # block by block: an MoE block against the first MoE block, a dense
    # one against the first dense block
    bad = jax.tree_util.tree_map(lambda x: x, params)
    bad["block_3"]["moe"]["w_up"] = np.zeros((4, D_MODEL, D_FF + 1), np.float32)
    with pytest.raises(ValueError, match="block_3/moe/w_up"):
        lm_params.lm_params_from_flax(bad, device="cpu")
    bad = jax.tree_util.tree_map(lambda x: x, params)
    del bad["block_1"]["moe"]["w_down"]
    with pytest.raises(KeyError, match="block_1/moe/w_down"):
        lm_params.lm_params_from_flax(bad, device="cpu", cfg=cfg)
    bad = jax.tree_util.tree_map(lambda x: x, params)
    bad["block_2"]["up"] = {"kernel": np.zeros((D_MODEL, D_FF + 1), np.float32)}
    with pytest.raises(ValueError, match="block_2/up/kernel"):
        lm_params.lm_params_from_flax(bad, device="cpu")
    # seeded init: Flax's fan-in of a stacked expert tensor counts the
    # expert axis (fan_in = E * d for w_up [E, d, d_ff])
    a = lm_params.init_lm_params(cfg, seed=2, device="cpu", num_experts=4, moe_every=2)
    assert "moe" in a["block_1"] and "up" in a["block_2"] and "moe" not in a["block_0"]
    for leaf, fan_in in (("w_up", 4 * D_MODEL), ("w_down", 4 * D_FF)):
        w = a["block_1"]["moe"][leaf]
        std = fan_in ** -0.5
        assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
        assert abs(float(w.std()) - std) < 0.1 * std, leaf
        # against the JAX initializer's own spread
        assert abs(float(w.std()) - float(params["block_1"]["moe"][leaf].std())) < 0.1 * std, leaf
    router = a["block_3"]["moe"]["router"]["kernel"]
    assert abs(float(router.std()) - D_MODEL ** -0.5) < 0.2 * D_MODEL ** -0.5
