"""The port's native JPEG loader against the JAX package's, on the CPU.

`dml_tpu_torch.models.preprocess.load_images` sends an all-JPEG batch
through the port's own copy of the libjpeg loader
(`dml_tpu_torch/native/`), as `dml_tpu.models.preprocess.load_images`
sends it through `native/`. Both must give the same uint8 batch, bit for
bit: natively, with PIL forced (`DML_NATIVE_LOADER=0`), and when a
truncated file sends both to PIL. Where g++ or libjpeg is missing, the
native cases skip with the build error as the reason.
"""

import os

import numpy as np
import pytest
from PIL import Image

from dml_tpu.models import preprocess as jax_pre
from dml_tpu.native import loader as jax_loader
from dml_tpu_torch.models import preprocess as pre
from dml_tpu_torch.native import loader

SHAPES = ((480, 640), (375, 500), (224, 224), (600, 400))


def _jpegs(dirname, seed=0):
    """Four synthetic JPEGs: gradients plus seeded noise, quality 90."""
    rng = np.random.RandomState(seed)
    paths = []
    for i, (h, w) in enumerate(SHAPES):
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 255 // (h + w)], -1)
        img = np.clip(base + rng.randint(-40, 40, (h, w, 3)), 0, 255).astype(np.uint8)
        p = os.path.join(dirname, f"img{i}.jpg")
        Image.fromarray(img).save(p, quality=90)
        paths.append(p)
    return paths


@pytest.fixture
def native():
    if not loader.native_available():
        pytest.skip(f"the port's native loader did not build: {loader.build_error()}")
    if not jax_loader.native_available():
        pytest.skip("the JAX package's native loader did not build")


@pytest.mark.parametrize("size", [(224, 224), (299, 299)], ids=["224", "299"])
def test_jpeg_batch_equals_jax_native(native, tmp_path, size):
    paths = _jpegs(str(tmp_path))
    before = dict(pre.decoded_batches)
    got = pre.load_images(paths, size)
    assert pre.decoded_batches["native"] == before["native"] + 1
    assert pre.decoded_batches["pil"] == before["pil"]
    want = jax_pre.load_images(paths, size)
    assert got.dtype == np.uint8 and got.shape == (len(paths), *size, 3)
    np.testing.assert_array_equal(got, want)
    # the port builds into its own git-ignored directory, never native/
    assert os.path.dirname(loader.library_path()) == loader.BUILD_DIR
    assert os.path.exists(loader.library_path())


def test_forced_pil_and_truncated_jpeg_fall_back_like_jax(native, tmp_path, monkeypatch):
    paths = _jpegs(str(tmp_path), seed=1)
    size = (224, 224)
    native_batch = pre.load_images(paths, size)
    monkeypatch.setenv("DML_NATIVE_LOADER", "0")
    assert loader.get_loader() is None
    before = dict(pre.decoded_batches)
    forced = pre.load_images(paths, size)
    assert pre.decoded_batches["pil"] == before["pil"] + 1
    np.testing.assert_array_equal(forced, jax_pre.load_images(paths, size))
    assert (forced != native_batch).any()  # PIL's resize is not the loader's
    monkeypatch.delenv("DML_NATIVE_LOADER")
    with open(paths[1], "rb") as f:
        data = f.read()
    # truncated inside the scan: libjpeg warns and fills the rest, so the
    # native loader serves the batch, on both sides alike
    cut = os.path.join(str(tmp_path), "cut_scan.jpg")
    with open(cut, "wb") as f:
        f.write(data[: len(data) // 2])
    before = dict(pre.decoded_batches)
    got = pre.load_images([paths[0], cut], size)
    assert pre.decoded_batches["native"] == before["native"] + 1
    np.testing.assert_array_equal(got, jax_pre.load_images([paths[0], cut], size))
    # truncated inside the header: the native decode raises, PIL decides,
    # and PIL raises too, on both sides
    cut_header = os.path.join(str(tmp_path), "cut_header.jpg")
    with open(cut_header, "wb") as f:
        f.write(data[:100])
    with pytest.raises(RuntimeError, match="native decode failed"):
        loader.get_loader().decode_batch([cut_header], size)
    with pytest.raises(OSError):
        pre.load_images([paths[0], cut_header], size)
    with pytest.raises(OSError):
        jax_pre.load_images([paths[0], cut_header], size)
    # a CMYK JPEG: libjpeg will not convert it to RGB, so the native
    # decode raises and PIL decodes the whole batch, on both sides alike
    cmyk = os.path.join(str(tmp_path), "cmyk.jpg")
    Image.open(paths[2]).convert("CMYK").save(cmyk, quality=90)
    with pytest.raises(RuntimeError, match="color conversion"):
        loader.get_loader().decode_batch([cmyk], size)
    before = dict(pre.decoded_batches)
    got = pre.load_images([paths[0], cmyk], size)
    assert pre.decoded_batches["pil"] == before["pil"] + 1
    np.testing.assert_array_equal(got, jax_pre.load_images([paths[0], cmyk], size))


def test_no_compiler_falls_back_to_pil_with_the_error(tmp_path, monkeypatch):
    monkeypatch.setattr(loader, "_loader", None)
    monkeypatch.setattr(loader, "_error", None)
    monkeypatch.setattr(loader, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert not loader.native_available()
    assert "no-such-compiler" in loader.build_error()
    paths = _jpegs(str(tmp_path), seed=2)[2:]
    before = dict(pre.decoded_batches)
    got = pre.load_images(paths, (64, 48))
    assert pre.decoded_batches == dict(before, pil=before["pil"] + 1)
    want = np.stack([pre.decode_image(open(p, "rb").read(), (64, 48)) for p in paths])
    np.testing.assert_array_equal(got, want)
    assert pre.load_images([], (64, 48)).shape == (0, 64, 48, 3)
