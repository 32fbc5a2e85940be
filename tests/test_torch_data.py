"""The port's input pipeline (`dml_tpu_torch.data`) and `normalize_sharded`
against the JAX package's, on the CPU.

- `ImageDataset.batch_plan`: the same batches for the same (seed, epoch).
- `load_batch`: bit-equal uint8 batches and labels on seeded PNGs (PIL in
  both packages) and JPEGs (each package's native libjpeg loader where
  it builds, PIL in both where it does not).
- `Prefetcher`: the epoch in order, reusable, errors surfaced on the
  consumer's side, early exit retires the producer. Its device form
  (pinned copies on a stream of its own, an event the consumer waits
  on) needs a card: chip_smoke.py's image_train phase drives it.
- `normalize_sharded`: bit-equal to the JAX package's on the CPU (there
  the jnp `normalize_on_device`) in every mode and output dtype; a mesh
  of more than one device raises.

Kept to few test functions: pytest-xdist's loadfile scheduler orders
files by their test count (see tests/test_torch_models.py).
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_tpu import data as jax_data
from dml_tpu.config import MeshSpec
from dml_tpu.ops.preprocess import normalize_sharded as jax_normalize_sharded
from dml_tpu.parallel.mesh import make_mesh
from dml_tpu_torch import data
from dml_tpu_torch.ops import preprocess as ops


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(0)
    out = {"png": [], "jpeg": []}
    for i in range(10):
        im = Image.fromarray(rng.randint(0, 256, (40 + i, 48, 3)).astype(np.uint8))
        for fmt in out:
            p = d / f"img_{i}.{fmt}"
            im.save(p, **({"quality": 90} if fmt == "jpeg" else {}))
            out[fmt].append((str(p), i % 3))
    return out


@pytest.mark.parametrize("seed,epoch,shuffle,drop", [
    (7, 0, True, True), (7, 1, True, False), (0, 3, False, False), (123456, 2, True, True)])
def test_batch_plan_matches_jax(samples, seed, epoch, shuffle, drop):
    kw = dict(image_size=(32, 32), batch_size=4, shuffle=shuffle, seed=seed, drop_remainder=drop)
    mine = data.ImageDataset(samples["png"], **kw)
    want = jax_data.ImageDataset(samples["png"], **kw)
    assert len(mine) == len(want)
    assert mine.batch_plan(epoch) == want.batch_plan(epoch)


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_load_batch_is_bit_equal_to_jax(samples, fmt):
    kw = dict(image_size=(36, 28), batch_size=5, seed=1)
    mine = data.ImageDataset(samples[fmt], **kw)
    want = jax_data.ImageDataset(samples[fmt], **kw)
    for (images, labels), (j_images, j_labels) in zip(mine.epoch(1), want.epoch(1)):
        assert images.dtype == np.uint8 and images.shape == (5, 36, 28, 3)
        assert labels.dtype == np.int32
        np.testing.assert_array_equal(images, j_images)
        np.testing.assert_array_equal(labels, j_labels)


def test_prefetcher_order_reuse_errors_and_early_exit(samples):
    ds = data.ImageDataset(samples["png"], image_size=(32, 32), batch_size=2, seed=3)
    direct = [(i.tobytes(), l.tobytes()) for i, l in ds.epoch(2)]
    pf = data.Prefetcher(ds, epoch=2)
    for _ in range(2):  # reusable: a second pass gives the same epoch
        assert [(i.tobytes(), l.tobytes()) for i, l in pf] == direct
    assert pf._error is None

    # a decode error surfaces on the consumer's side, after the good batch
    bad = samples["png"][:2] + [("/nonexistent/file.png", 0)] + samples["png"][2:3]
    pf_bad = data.Prefetcher(data.ImageDataset(bad, image_size=(32, 32), batch_size=2,
                                               shuffle=False))
    got = []
    with pytest.raises(FileNotFoundError):
        for batch in pf_bad:
            got.append(batch)
    assert len(got) == 1 and isinstance(pf_bad._error, FileNotFoundError)

    # early exit retires the producer; a second iterator is refused meanwhile
    pf1 = data.Prefetcher(data.ImageDataset(samples["png"], image_size=(32, 32), batch_size=1),
                          depth=1)
    it = iter(pf1)
    next(it)
    with pytest.raises(RuntimeError, match="already being iterated"):
        next(iter(pf1))
    it.close()
    deadline = time.monotonic() + 5
    while pf1._thread.is_alive() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not pf1._thread.is_alive()
    assert not any(t.name == "dml-prefetch" and t.is_alive() for t in threading.enumerate())
    with pytest.raises(ValueError):
        data.Prefetcher(ds, depth=0)


@pytest.mark.parametrize("mode", ["caffe", "tf", "unit", "raw"])
def test_normalize_sharded_is_bit_equal_to_jax(mode):
    x = np.random.RandomState(4).randint(0, 256, (4, 9, 7, 3)).astype(np.uint8)
    mesh = make_mesh(MeshSpec(dp=1), devices=jax.devices()[:1])
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(jax_normalize_sharded(jnp.asarray(x), mode, jdt, mesh)
                          ).astype(np.float32)
        for m in (None, mesh, {"dp": 1}):
            before = ops.normalize_launches
            got = ops.normalize_sharded(torch.from_numpy(x), mode, dtype, m)
            assert ops.normalize_launches == before  # CPU: the plain version
            assert got.dtype == dtype and got.shape == x.shape
            np.testing.assert_array_equal(got.float().numpy(), want)
    # a mesh of two ranks in a world of one (no process group)
    with pytest.raises(ValueError, match="asks for 2 ranks but the world has 1"):
        ops.normalize_sharded(torch.from_numpy(x), mode, torch.float32,
                              make_mesh(MeshSpec(dp=2), devices=jax.devices()[:2]))
    with pytest.raises(ValueError, match="asks for 2 ranks but the world has 1"):
        ops.normalize_sharded(torch.from_numpy(x), mode, torch.float32, {"dp": 2, "tp": 1})
