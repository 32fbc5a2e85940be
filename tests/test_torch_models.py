"""The port's ResNets against the JAX package's on the CPU, same weights.

Weights are initialised in JAX (`init_variables` / `model.init`) and then
given BN statistics, scales and shifts drawn with numpy from a seed: with
Flax's init alone (mean 0, var 1, scale 1, shift 0) a swapped mean/var
or a dropped BN shift would go unseen. Both packages get the same tree;
the port converts it with `params_io.from_flax_variables`.

Tolerances:
- float32: probabilities within atol 1e-4 and the same top-5. Measured
  maximum on a CPU run with these seeds: 1.7e-6 (ResNet50 at 64x64),
  1.2e-6 (narrow ResNet).
- bfloat16 against JAX bfloat16: the same top-1 and probabilities within
  5e-2 (measured: 7.2e-3). Both compute BN in float32 from the bf16 conv
  output and round once, but the two CPU backends sum the convolutions
  in different orders. For scale: on seed 0 at 64x64 with Flax's own init,
  JAX's f32 and bf16 top probabilities are 0.929 and 0.884.

Kept to three test functions or fewer: pytest-xdist's loadfile scheduler
orders files by their test count, so a small count runs the port's files
last, after the cluster simulations that share fixed UDP ports.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_tpu.models.resnet import ResNet as JaxResNet
from dml_tpu.models.resnet import ResNet50 as JaxResNet50
from dml_tpu.models.preprocess import normalize_on_device as jax_normalize
from dml_tpu_torch.models.params_io import from_flax_variables
from dml_tpu_torch.models.preprocess import normalize_on_device
from dml_tpu_torch.models.resnet import ResNet, ResNet50


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the tests run beside other test processes on a shared CPU; torch's
    # default of one thread per core oversubscribes it
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def perturb_bn(variables, seed):
    """Return a copy of a numpy Flax tree with seeded BN parameters."""
    rng = np.random.RandomState(seed)
    params = {k: dict(v) for k, v in variables["params"].items()}
    stats = {k: dict(v) for k, v in variables["batch_stats"].items()}
    for layer in sorted(stats):
        n = stats[layer]["mean"].shape[0]
        stats[layer]["mean"] = rng.normal(0, 0.2, n).astype(np.float32)
        stats[layer]["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
        params[layer]["bias"] = rng.normal(0, 0.2, n).astype(np.float32)
        if "scale" in params[layer]:
            params[layer]["scale"] = rng.uniform(0.5, 1.0, n).astype(np.float32)
    return {"params": params, "batch_stats": stats}


def jax_init(model, size, seed=0):
    x = jnp.zeros((1, size, size, 3), jnp.float32)
    v = jax.jit(lambda k: model.init(k, x, train=False))(jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, v)


def images(n, size, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, size, size, 3)).astype(np.uint8)


def run_both(jax_model, torch_model, variables, imgs, mode, jdt, tdt):
    pj = np.asarray(
        jax_model.apply(variables, jax_normalize(jnp.asarray(imgs), mode, jdt), train=False)
    )
    torch_model.load_state_dict(from_flax_variables(variables, torch_model))
    torch_model = torch_model.eval().to(memory_format=torch.channels_last)
    with torch.inference_mode():
        pt = torch_model(normalize_on_device(torch.from_numpy(imgs), mode, tdt)).numpy()
    assert pt.dtype == np.float32 and pt.shape == pj.shape
    return pj, pt


def assert_f32_parity(pj, pt):
    np.testing.assert_allclose(pt, pj, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(
        np.argsort(-pt, -1)[:, :5], np.argsort(-pj, -1)[:, :5]
    )


@pytest.fixture(scope="module")
def resnet50_variables():
    return perturb_bn(jax_init(JaxResNet50(dtype=jnp.float32), 64), seed=1)


def test_narrow_resnet_f32_matches_jax():
    depths = (1, 1, 1, 1)
    v = perturb_bn(jax_init(JaxResNet(depths=depths, num_classes=10), 32), seed=2)
    pj, pt = run_both(
        JaxResNet(depths=depths, num_classes=10), ResNet(depths=depths, num_classes=10),
        v, images(3, 32), "caffe", jnp.float32, torch.float32,
    )
    assert pt.shape == (3, 10)
    assert_f32_parity(pj, pt)


def test_resnet50_f32_matches_jax(resnet50_variables):
    pj, pt = run_both(
        JaxResNet50(dtype=jnp.float32), ResNet50(dtype=torch.float32),
        resnet50_variables, images(2, 64), "caffe", jnp.float32, torch.float32,
    )
    assert_f32_parity(pj, pt)


def test_resnet50_bf16_matches_jax_bf16(resnet50_variables):
    pj, pt = run_both(
        JaxResNet50(dtype=jnp.bfloat16), ResNet50(dtype=torch.bfloat16),
        resnet50_variables, images(2, 64), "caffe", jnp.bfloat16, torch.bfloat16,
    )
    np.testing.assert_array_equal(pt.argmax(-1), pj.argmax(-1))
    np.testing.assert_allclose(pt, pj, atol=5e-2, rtol=0)
