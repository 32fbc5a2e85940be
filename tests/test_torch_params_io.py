"""Weights carried from the JAX package's layout into the port's modules.

Round trips: a JAX-initialised tree, given as the nested
{'params', 'batch_stats'} tree and as the npz fixture that
`dml_tpu.models.params_io.save_npz_fixture` writes, converts to the same
state_dict, and every leaf maps back to the Flax value exactly (the
conversion is a transpose and a float32 copy, so the tolerance is 0).

Kept to three test functions or fewer: pytest-xdist's loadfile scheduler
orders files by their test count, so a small count runs the port's files
last, after the cluster simulations that share fixed UDP ports.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_tpu.models.params_io import save_npz_fixture
from dml_tpu.models.resnet import ResNet as JaxResNet
from dml_tpu_torch.models import ModelSpec, get_model
from dml_tpu_torch.models.inception import InceptionV3
from dml_tpu_torch.models.params_io import (
    from_flax_variables,
    init_variables,
    load_npz_fixture,
)
from dml_tpu_torch.models.resnet import ResNet

DEPTHS = (1, 1, 1, 1)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the tests run beside other test processes on a shared CPU; torch's
    # default of one thread per core oversubscribes it
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flax_tree():
    model = JaxResNet(depths=DEPTHS, num_classes=10)
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    v = jax.jit(lambda k: model.init(k, x, train=False))(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, v)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _back_to_flax(key, t):
    """Invert the layout mapping for one Flax leaf key."""
    a = t.numpy()
    if key.endswith("/kernel"):
        return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
    return a


def _torch_key(key):
    coll, layer, leaf = key.split("/")
    name = {"kernel": "weight", "scale": "weight", "bias": "bias",
            "mean": "running_mean", "var": "running_var"}[leaf]
    return f"{layer}.{name}"


def test_nested_tree_and_npz_fixture_round_trip(flax_tree, tmp_path):
    module = ResNet(depths=DEPTHS, num_classes=10)
    sd = from_flax_variables(flax_tree, module)
    assert set(sd) == set(module.state_dict())
    flat = _flat(flax_tree)
    assert len(flat) == len(sd)
    for key, want in flat.items():
        got = _back_to_flax(key, sd[_torch_key(key)])
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=key)
    assert sd["conv1_conv.weight"].shape == (64, 3, 7, 7)  # OIHW
    assert sd["predictions.weight"].shape == (10, 2048)  # [out, in]
    module.load_state_dict(sd)  # strict

    # the npz fixture that the JAX package writes gives the same state_dict
    path = str(tmp_path / "resnet.npz")
    save_npz_fixture(path, flax_tree, class_index_json='{"0": ["n0", "zero"]}')
    npz, cij = load_npz_fixture(path)
    assert cij == '{"0": ["n0", "zero"]}'
    assert set(npz) == set(flat)
    from_npz = from_flax_variables(npz, module)
    assert set(from_npz) == set(sd)
    for k in sd:
        assert torch.equal(from_npz[k], sd[k]), k
    # a fixture without an embedded class index
    save_npz_fixture(path, flax_tree)
    assert load_npz_fixture(path)[1] is None


def test_bad_keys_raise_and_bn_without_scale_gets_unit_weight(flax_tree):
    module = ResNet(depths=DEPTHS, num_classes=10)
    flat = _flat(flax_tree)
    missing = {k: v for k, v in flat.items() if k != "params/conv3_block1_2_conv/bias"}
    with pytest.raises(KeyError, match="conv3_block1_2_conv.bias"):
        from_flax_variables(missing, module)
    extra = dict(flat, **{"params/conv9_conv/kernel": np.zeros((1, 1, 3, 4), np.float32)})
    with pytest.raises(KeyError, match="conv9_conv.weight"):
        from_flax_variables(extra, module)
    odd_leaf = dict(flat, **{"params/conv1_conv/gamma": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="params/conv1_conv/gamma"):
        from_flax_variables(odd_leaf, module)
    bad = dict(flat, **{"params/predictions/bias": np.zeros(11, np.float32)})
    with pytest.raises(ValueError, match="predictions.bias"):
        from_flax_variables(bad, module)

    # a BN built without a scale (InceptionV3) gets weight = ones
    tree = {
        "params": {"conv2d_0": {"kernel": np.ones((3, 3, 3, 32), np.float32)},
                   "batch_normalization_0": {"bias": np.full(32, 0.5, np.float32)}},
        "batch_stats": {"batch_normalization_0": {"mean": np.zeros(32, np.float32),
                                                  "var": np.ones(32, np.float32)}},
    }
    sd = from_flax_variables(tree)
    assert torch.equal(sd["batch_normalization_0.weight"], torch.ones(32))
    assert torch.equal(sd["batch_normalization_0.bias"], torch.full((32,), 0.5))
    assert sd["conv2d_0.weight"].shape == (32, 3, 3, 3)


def test_init_variables_is_seeded_and_follows_flax_init():
    narrow = ModelSpec(
        name="NarrowResNet", input_size=(32, 32), preprocess="caffe",
        builder=lambda num_classes, dtype: ResNet(DEPTHS, num_classes, dtype),
        cost=get_model("ResNet50").cost,
    )
    a = init_variables(narrow, seed=3, num_classes=10)
    b = init_variables(narrow, seed=3, num_classes=10)
    c = init_variables(narrow, seed=4, num_classes=10)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv3_block1_2_conv.weight"], c["conv3_block1_2_conv.weight"])
    assert a["predictions.weight"].shape == (10, 2048)

    inc = init_variables(get_model("InceptionV3"), seed=3)
    assert set(inc) == set(InceptionV3().state_dict())
    w = inc["conv2d_93.weight"]  # 3x1 conv, 384 in: fan_in 1152
    std = (1 / w[0].numel()) ** 0.5
    assert w.abs().max() <= 2 * std / 0.87962566103423978 + 1e-6  # truncated at 2 sigma
    assert abs(float(w.std()) / std - 1) < 0.02  # lecun-normal variance 1/fan_in
    bn = "batch_normalization_7"
    assert torch.equal(inc[f"{bn}.weight"], torch.ones_like(inc[f"{bn}.weight"]))
    assert torch.equal(inc[f"{bn}.running_var"], torch.ones_like(inc[f"{bn}.running_var"]))
    assert float(inc[f"{bn}.running_mean"].abs().max()) == 0.0
    assert float(inc["predictions.bias"].abs().max()) == 0.0
