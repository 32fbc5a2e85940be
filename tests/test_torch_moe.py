"""The port's mixture-of-experts layer (dml_tpu_torch/parallel/moe.py) and
the MoE form of its TransformerLM against the JAX package, on the CPU.

Weights come from the JAX modules' `init` and cross as numpy; inputs
are numpy, seeded. Tolerances: `top2_dispatch`'s dispatch, combine and
aux within 1e-6 (the same float32 routing math); `MoEMLP`'s output and
aux within 1e-4, the bar of tests/test_moe.py; gradients of mean(y**2)
within atol 5e-5, rtol 5e-4 (the gradient bar of tests/test_ops.py);
TransformerLM logits within 2e-4, the bar of tests/test_generate.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_tpu.models.transformer import TransformerLM as JaxLM
from dml_tpu.parallel.moe import MoEMLP as JaxMoE
from dml_tpu.parallel.moe import top2_dispatch as jax_top2
from dml_tpu_torch.models import lm_params
from dml_tpu_torch.models.transformer import TransformerLM
from dml_tpu_torch.parallel import moe


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the tests run beside other test processes on a shared CPU; torch's
    # default of one thread per core oversubscribes it
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _gate_logits(case):
    rng = np.random.RandomState(0)
    if case == "random":
        return rng.randn(3, 12, 4).astype(np.float32), 3  # three groups, some drops
    if case == "tied":
        # equal top gates: both packages take the lower index first
        return np.asarray([[1, 1, 0, 0], [0, 2, 2, 2], [0, 0, 0, 0], [3, 1, 3, 1],
                           [0, 1, 1, 0], [5, 5, 5, 5]], np.float32)[None], 6  # no drops
    # tests/test_moe.py's capacity-drop case: every token prefers expert 0
    logits = np.zeros((1, 8, 2), np.float32)
    logits[..., 0] = 5.0
    return logits, 2


@pytest.mark.parametrize("case", ["random", "tied", "capacity_drop"])
def test_top2_dispatch_matches_jax(case):
    logits, cap = _gate_logits(case)
    gates = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    want = jax.vmap(lambda g: jax_top2(g, cap))(jnp.asarray(gates))
    got = moe.top2_dispatch(torch.from_numpy(gates), cap)
    for name, a, b in zip(("dispatch", "combine", "aux"), got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, err_msg=name)
    dispatch = got[0].numpy()
    assert (dispatch.sum(axis=1) <= 1).all()  # each (expert, slot) holds one token at most
    if case == "capacity_drop":
        assert dispatch[0, :, 0].sum() == cap and dispatch[0, :, 1].sum() == cap
    if case == "tied":
        # ties go to the lower index first: row 0 to experts 0 and 1, row 1 to 1 and 2
        assert dispatch[0, 0, :2].sum() == 2 and dispatch[0, 1, 1:3].sum() == 2


# name -> (b, t, e, group_size, capacity_factor)
MLP_CASES = {
    "ample": (2, 6, 4, 1024, 8.0),
    "groups": (2, 8, 4, 4, 16.0),  # two groups of 4 per row
    "t5_fallback": (2, 5, 4, 4, 8.0),  # no divisor of 5 in 2..4: groups of 1
    "drops": (2, 16, 4, 1024, 0.5),  # capacity 2 of 16 tokens: most drop
}
D, D_FF = 8, 16


def _mlp_pair(name):
    b, t, e, gs, cf = MLP_CASES[name]
    jm = JaxMoE(num_experts=e, d_ff=D_FF, capacity_factor=cf, group_size=gs, dtype=jnp.float32)
    x = np.random.RandomState(1).randn(b, t, D).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    tm = moe.MoEMLP(D, e, D_FF, capacity_factor=cf, group_size=gs, dtype=torch.float32)
    tm.load_state_dict({"router.kernel": torch.tensor(np.asarray(params["router"]["kernel"])),
                        "w_up": torch.tensor(np.asarray(params["w_up"])),
                        "w_down": torch.tensor(np.asarray(params["w_down"]))})
    return jm, params, tm, x


@pytest.mark.parametrize("name", list(MLP_CASES))
def test_moe_mlp_matches_jax(name):
    jm, params, tm, x = _mlp_pair(name)
    want, sown = jm.apply({"params": params}, jnp.asarray(x), mutable=["losses"])
    (want_aux,) = sown["losses"]["moe_aux"]
    y, aux = tm(torch.from_numpy(x))
    assert y.shape == x.shape and aux.ndim == 0
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(float(aux.detach()), float(want_aux), atol=1e-4)
    if name == "drops":  # some token lost both choices: its output is 0
        assert (np.abs(np.asarray(want)).sum(-1) == 0).any()


@pytest.mark.parametrize("name", ["ample", "drops"])
def test_moe_mlp_gradients_match_jax(name):
    jm, params, tm, x = _mlp_pair(name)

    def loss(p):
        return jnp.mean(jm.apply({"params": p}, jnp.asarray(x)) ** 2)

    grads = jax.grad(loss)(params)
    y, _ = tm(torch.from_numpy(x))
    (y ** 2).mean().backward()
    for got, want in ((tm.w_up.grad, grads["w_up"]), (tm.w_down.grad, grads["w_down"]),
                      (tm.router.kernel.grad, grads["router"]["kernel"])):
        assert float(got.abs().max()) > 0
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=5e-4)


def test_group_size_capacity_and_one_device_only():
    assert [moe.group_size_for(t, 1024) for t in (5, 2048, 1100, 4096)] == [5, 1024, 550, 1024]
    assert moe.group_size_for(5, 4) == 1 and moe.group_size_for(8, 4) == 4
    # a mesh of more ranks than the world is refused (the experts over ep:
    # tests/test_torch_seq_parallel.py); a one-device mesh is plain
    with pytest.raises(ValueError, match="the world has 1"):
        moe.MoEMLP(D, 4, D_FF, mesh={"dp": 1, "ep": 2})
    plain = moe.MoEMLP(D, 4, D_FF, mesh={"dp": 1, "ep": 1})
    assert plain.mesh is None and plain.w_up.shape == (4, D, D_FF)
    # the JAX rule: E over ep when ep > 1 divides it, else replicated
    w = torch.zeros(4, D, D_FF)
    assert moe.moe_partition_spec(("w_up",), w, {"ep": 4}) == ("ep", None, None)
    assert moe.moe_partition_spec(("moe", "w_down"), w, {"ep": 2}) == ("ep", None, None)
    assert moe.moe_partition_spec(("w_up",), w, {"ep": 3}) == ()
    assert moe.moe_partition_spec(("moe", "w_up"), None, None) == ()
    assert moe.moe_partition_spec(("moe", "router", "kernel"), w, {"ep": 4}) is None
    assert [moe.expert_shards(8, {"ep": e}) for e in (1, 2, 3, 8)] == [1, 2, 1, 8]


def test_transformer_lm_with_moe_matches_jax():
    shape = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=4, d_ff=64, num_experts=4,
                 moe_every=2)
    jlm = JaxLM(dtype=jnp.float32, **shape)
    tokens = np.random.RandomState(4).randint(0, 64, (2, 8)).astype(np.int32)
    params = jlm.init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]
    want, sown = jlm.apply({"params": params}, jnp.asarray(tokens), mutable=["losses"])
    want_aux = [float(sown["losses"][f"block_{i}"]["moe"]["moe_aux"][0]) for i in (1, 3)]

    lm = TransformerLM(dtype=torch.float32, **shape)
    assert hasattr(lm.block_1, "moe") and hasattr(lm.block_0, "up") and not hasattr(lm.block_3, "up")
    tree = lm_params.lm_params_from_flax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    lm.load_state_dict(lm_params.state_dict_of(tree))
    with torch.no_grad():
        logits, aux = lm(torch.from_numpy(tokens), return_aux=True)
        plain = lm(torch.from_numpy(tokens))
    assert torch.equal(plain, logits)  # forward alone returns the logits
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=2e-4)
    np.testing.assert_allclose([float(a) for a in aux], want_aux, atol=1e-4)
