"""The port's InferenceEngine on the CPU against the JAX package's engine.

Both engines serve ResNet50 in float32 at batch size 4 with the same
JAX-initialised weights (BN parameters drawn from a seed, see
test_torch_models.perturb_bn). Outputs agree within atol 1e-4 with the
same top-5, the float32 bar of the model tests; the port's nowait path
equals its sync path exactly (same ops, same order, on the CPU).

Kept to three test functions or fewer: pytest-xdist's loadfile scheduler
orders files by their test count, so a small count runs the port's files
last, after the cluster simulations that share fixed UDP ports.
"""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_tpu.inference.engine import InferenceEngine as JaxEngine
from dml_tpu.models.resnet import ResNet50 as JaxResNet50
from dml_tpu_torch.inference import InferenceEngine
from dml_tpu_torch.ops import preprocess as torch_ops

from test_torch_models import jax_init, perturb_bn

BS = 4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the tests run beside other test processes on a shared CPU; torch's
    # default of one thread per core oversubscribes it
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    return perturb_bn(jax_init(JaxResNet50(dtype=jnp.float32), 64), seed=5)


@pytest.fixture(scope="module")
def engines(weights):
    jax_engine = JaxEngine(dtype=jnp.float32)
    jax_engine.load_model("ResNet50", variables=weights, batch_size=BS)
    port = InferenceEngine(dtype=torch.float32, device="cpu")
    port.load_model("ResNet50", variables=weights, batch_size=BS)
    return jax_engine, port


def _images(n, seed):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (n, 224, 224, 3))
    return np.clip(imgs // 2 + rng.randint(0, 128, (n, 1, 1, 3)), 0, 255).astype(np.uint8)


def _assert_close(pt, pj):
    np.testing.assert_allclose(pt, pj, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(np.argsort(-pt, -1)[:, :5], np.argsort(-pj, -1)[:, :5])


def test_infer_arrays_pads_and_matches_jax(engines):
    jax_engine, port = engines
    imgs = _images(5, seed=0)  # one full chunk, one padded chunk of 1
    before = torch_ops.normalize_launches
    pt = port.infer_arrays("ResNet50", imgs)
    assert torch_ops.normalize_launches == before  # the CPU runs no kernel
    pj = jax_engine.infer_arrays("ResNet50", imgs)
    assert pt.shape == (5, 1000) and pt.dtype == np.float32
    _assert_close(pt, pj)
    np.testing.assert_allclose(pt.sum(-1), 1.0, rtol=1e-5)
    assert port.infer_arrays("ResNet50", imgs[:0]).shape == (0, 1000)


def test_infer_arrays_nowait_equals_sync(engines):
    _, port = engines
    imgs = _images(9, seed=1)  # 3 chunks
    sync = port.infer_arrays("ResNet50", imgs)
    handle = port.infer_arrays_nowait("ResNet50", imgs)
    got = handle()
    np.testing.assert_array_equal(got, sync)
    assert handle() is got  # a re-read returns the drained result
    assert port.infer_arrays_nowait("ResNet50", imgs[:0])().shape == (0, 1000)


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_infer_files_top5_wnids_match_jax(engines, tmp_path, fmt):
    from PIL import Image

    jax_engine, port = engines
    files = []
    for i, im in enumerate(_images(3, seed=2)):
        # PNG: both packages decode with PIL; JPEG: both with their native
        # loader where it builds (else PIL), the main path's input
        p = tmp_path / f"img{i}.{fmt}"
        Image.fromarray(im[:150, :190]).save(p, **({"quality": 90} if fmt == "jpeg" else {}))
        files.append(str(p))
    rt = port.infer_files("ResNet50", files)
    rj = jax_engine.infer_files("ResNet50", files)
    assert rt.files == files and rt.batch_padded_to == BS
    assert [[w for w, _, _ in t] for t in rt.top5] == [[w for w, _, _ in t] for t in rj.top5]
    for t, j in zip(rt.top5, rj.top5):
        np.testing.assert_allclose([s for _, _, s in t], [s for _, _, s in j], atol=1e-4)
    d = rt.to_json_dict()
    assert set(d) == set(files) and {"wnid", "label", "score"} == set(d[files[0]][0])
    ra = asyncio.run(port.infer_files_async("ResNet50", files))
    assert ra.top5 == rt.top5
