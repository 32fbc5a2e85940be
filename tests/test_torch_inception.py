"""The port's InceptionV3 against the JAX package's on the CPU, same
weights (set up as in test_torch_models.py), plus the layer names and the
registry of the ported families.

Tolerance: float32 probabilities within atol 1e-4 and the same top-5
(measured maximum on a CPU run with this seed: 1.2e-6).

Kept to three test functions or fewer: pytest-xdist's loadfile scheduler
orders files by their test count, so a small count runs the port's files
last, after the cluster simulations that share fixed UDP ports.
"""

import jax.numpy as jnp
import pytest
import torch

from dml_tpu.models.inception import InceptionV3 as JaxInceptionV3
from dml_tpu_torch.models import get_model
from dml_tpu_torch.models.inception import InceptionV3
from dml_tpu_torch.models.resnet import ResNet50

from test_torch_models import assert_f32_parity, images, jax_init, perturb_bn, run_both


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the tests run beside other test processes on a shared CPU; torch's
    # default of one thread per core oversubscribes it
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_inception_v3_f32_matches_jax():
    # 75x75: the smallest input the VALID stride-2 stem and reductions take
    v = perturb_bn(jax_init(JaxInceptionV3(dtype=jnp.float32), 75), seed=3)
    # the default head is nearly uniform over 1000 classes; a wider one
    # makes the softmax, and so the comparison, sensitive
    v["params"]["predictions"]["kernel"] = v["params"]["predictions"]["kernel"] * 30
    pj, pt = run_both(
        JaxInceptionV3(dtype=jnp.float32), InceptionV3(dtype=torch.float32),
        v, images(2, 75), "tf", jnp.float32, torch.float32,
    )
    assert pj.max() > 0.1  # the sharpened head is not uniform
    assert_f32_parity(pj, pt)


def test_state_dict_keys_and_registry():
    r = ResNet50()
    keys = r.state_dict().keys()
    assert {"conv1_conv.weight", "conv1_bn.running_var", "conv2_block1_0_bn.weight",
            "conv5_block3_3_conv.bias", "predictions.weight"} <= set(keys)
    inc = InceptionV3()
    assert inc.num_conv == 94
    assert "conv2d_93.weight" in inc.state_dict()
    assert "conv2d_0.bias" not in inc.state_dict()  # Keras convs have no bias
    assert torch.equal(inc.batch_normalization_0.weight, torch.ones(32))
    # the registry holds only the ported families
    assert get_model("resnet").name == "ResNet50"
    assert get_model("inception-v3").name == "InceptionV3"
    assert get_model("ResNet152").input_size == (224, 224)
    assert get_model("InceptionV3").preprocess == "tf"
    with pytest.raises(KeyError, match="registered: .*ResNet50"):
        get_model("MobileNetV2")  # not ported yet
    m = get_model("ResNet101").build(dtype=torch.bfloat16, num_classes=7)
    assert m.predictions.out_features == 7
    assert m.conv1_conv.weight.dtype == torch.bfloat16
    assert m.conv1_bn.running_mean.dtype == torch.float32
    assert m.predictions.weight.dtype == torch.float32
