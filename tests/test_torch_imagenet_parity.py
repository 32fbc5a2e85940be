"""The port's `tools/imagenet_parity` and the Keras/checkpoint helpers of
`models/params_io`, held to the JAX package.

- The JAX package's own cases of test_imagenet_parity, run against the
  port (`test_torch_cluster.port_cases`, the store cluster on a probed
  block). Left out by name: `test_npz_fixture_roundtrip`, which calls
  the JAX package's `load_npz_fixture(path, like)` with jax arrays (the
  port's reads a fixture without a template); its counterpart here
  holds each package's fixture to the other's reader. The cases that
  need the reference's golden outputs skip here, as they do for the JAX
  package.
- `load_keras_h5`/`from_keras_h5` on h5 files written with h5py from
  seeded trees (exact layer names, Keras counter names with an offset,
  a full-model save): JAX's result, leaf for leaf.
- test_keras_parity's cases through the port: a Keras model with random
  weights (TensorFlow on the CPU), converted by `from_keras_model`, gives
  Keras's probabilities through the port's module at the JAX test's
  tolerance; the same weights through a legacy .h5 give the same tree.
- `save_npz_fixture` against the JAX package's reader and writer;
  `save_checkpoint`/`load_checkpoint` round trip in the port's own
  one-file format, which the JAX package reads with
  `variables_from_bytes` (its `load_checkpoint` reads orbax directories,
  not this file, and the port's reads no orbax directory).
- `run_parity` on a seeded ResNet50 fixture and goldens made here: the
  port's engine (`device="cpu"`, float32) gives the JAX engine's top-5
  on every image, and the same report (agreements within 1e-6).
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import pytest
import torch

from dml_tpu.models import params_io as jpio
from dml_tpu.tools import imagenet_parity as jip
from dml_tpu_torch.models import params_io as tpio
from dml_tpu_torch.models.registry import get_model
from dml_tpu_torch.tools import imagenet_parity as tip

import test_torch_cluster as tc
from test_torch_cluster import TESTS, port_cases

#: calls `load_npz_fixture(path, like)` with jax arrays; counterpart:
#: test_npz_fixture_read_by_either_package below
EXCLUDE = ("test_npz_fixture_roundtrip",)
globals().update(port_cases("test_imagenet_parity", "imagenet_parity", exclude=EXCLUDE,
                            probe_ports=True))

#: cases test_imagenet_parity contributes at least (all but EXCLUDE)
MIN_CASES = {"imagenet_parity": 11}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_port_cases_cover_each_file():
    with open(os.path.join(TESTS, "test_imagenet_parity.py"), encoding="utf-8") as f:
        want = set(re.findall(r"^(?:async )?def test_(\w+)", f.read(), re.M))
    got = {k[len("imagenet_parity") + 6:] for k in globals()
           if k.startswith("test_imagenet_parity_")}
    assert got == want - {k[5:] for k in EXCLUDE}, sorted(want - got)
    assert len(got) >= MIN_CASES["imagenet_parity"]


def test_port_cases_take_the_parity_tool_and_leave_the_other_tools():
    """With the port's `tools` package in place, a case that needs the
    parity tool, the CLI or the new params_io helpers runs on the port;
    one that needs a tool that stays with the JAX package is still left
    out."""
    ported = ("from dml_tpu.tools import imagenet_parity as ip\n"
              "from dml_tpu.tools.imagenet_parity import run_parity, store_weight_names\n"
              "from dml_tpu.cli import NodeApp, main, default_log_path\n"
              "from dml_tpu.models.params_io import from_keras_h5, load_keras_h5, "
              "from_keras_model, save_checkpoint, load_checkpoint, save_npz_fixture\n")
    assert tc._unported(ported) == set()
    assert tc._unported("from dml_tpu.tools import claim_check as cc\n"
                        "from dml_tpu.tools.dmlflow import main\n"
                        "from dml_tpu.tools.parity_table import load_bench\n"
                        "from dml_tpu.tools import dmllint\n") == {
        "dml_tpu.tools.claim_check", "dml_tpu.tools.dmlflow", "dml_tpu.tools.parity_table",
        "dml_tpu.tools.dmllint"}


# ----------------------------------------------------------------------
# h5 files written with h5py
# ----------------------------------------------------------------------


def _flax_like(name):
    spec = get_model(name)
    tree = tpio.to_flax_variables(tpio.init_variables(spec), spec.build(dtype=torch.float32))
    return tpio._tree_map(tpio._numpy, tree)


def _write_legacy_h5(path, layers, model_weights=False):
    """The legacy topological Keras layout: layer groups in order, each
    naming its datasets '<layer>/<weight>:0' in `weight_names`."""
    import h5py

    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights") if model_weights else f
        root.attrs["layer_names"] = [n.encode() for n in layers]
        for lname, weights in layers.items():
            g = root.create_group(lname)
            g.attrs["weight_names"] = [f"{lname}/{w}:0".encode() for w, _ in weights]
            for w, arr in weights:
                g.create_dataset(f"{lname}/{w}:0", data=arr)


def _seeded_layers(seed, counter_offset=None):
    """(Flax-layout template, Keras layers {name: [(weight, array)]}):
    a conv with bias, a BN, a depthwise conv, a scale-less BN and a dense
    head, under the template's names, or with `counter_offset` under
    Keras counter names that start elsewhere (`conv2d_94` for the
    template's `conv2d_1`), and an empty input layer."""
    rng = np.random.RandomState(seed)

    def arr(*shape):
        return rng.normal(0, 1, shape).astype(np.float32)

    convs = {"conv2d_1": (3, 3, 3, 8), "conv2d_2": (1, 1, 8, 8), "conv2d_10": (3, 3, 8, 8)}
    tmpl = {"params": {}, "batch_stats": {}}
    keras = {"input_1": []}
    for i, (name, shape) in enumerate(convs.items()):
        tmpl["params"][name] = {"kernel": np.zeros(shape, np.float32)}
        kname = name if counter_offset is None else f"conv2d_{int(name[7:]) + counter_offset}"
        keras[kname] = [("kernel", arr(*shape))]
        bn = f"batch_normalization_{i + 1}"
        tmpl["params"][bn] = {"bias": np.zeros(8, np.float32)}
        tmpl["batch_stats"][bn] = {"mean": np.zeros(8, np.float32), "var": np.ones(8, np.float32)}
        kbn = bn if counter_offset is None else f"batch_normalization_{i + 1 + counter_offset}"
        keras[kbn] = [("beta", arr(8)), ("moving_mean", arr(8)),
                      ("moving_variance", np.abs(arr(8)) + 0.5)]
    tmpl["params"]["block_dwconv"] = {"kernel": np.zeros((3, 3, 1, 8), np.float32)}
    keras["block_dwconv"] = [("depthwise_kernel", arr(3, 3, 8, 1))]
    tmpl["params"]["block_bn"] = {"scale": np.ones(8, np.float32), "bias": np.zeros(8, np.float32)}
    tmpl["batch_stats"]["block_bn"] = {"mean": np.zeros(8, np.float32), "var": np.ones(8, np.float32)}
    keras["block_bn"] = [("gamma", arr(8)), ("beta", arr(8)), ("moving_mean", arr(8)),
                         ("moving_variance", np.abs(arr(8)) + 0.5)]
    tmpl["params"]["predictions"] = {"kernel": np.zeros((8, 10), np.float32),
                                     "bias": np.zeros(10, np.float32)}
    keras["predictions"] = [("kernel", arr(8, 10)), ("bias", arr(10))]
    return tmpl, keras


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def assert_same_tree(got, want):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("counter_offset,model_weights", [(None, False), (93, False), (93, True)],
                         ids=["exact-names", "counter-names", "full-model-save"])
def test_load_keras_h5_and_from_keras_h5_match_jax(tmp_path, counter_offset, model_weights):
    tmpl, keras = _seeded_layers(4, counter_offset)
    path = str(tmp_path / "w.h5")
    _write_legacy_h5(path, keras, model_weights)
    got, want = tpio.load_keras_h5(path), jpio.load_keras_h5(path)
    assert sorted(got) == sorted(want) == sorted(k for k, w in keras.items() if w)
    for layer in want:
        assert_same_tree(got[layer], want[layer])
    assert got["block_dwconv"]["kernel"].shape == (3, 3, 1, 8)
    tree = tpio.from_keras_h5(path, tmpl)
    assert_same_tree(tree, jpio.from_keras_h5(path, tmpl))
    # nothing of the template was written through, or aliased
    assert not tmpl["params"]["predictions"]["kernel"].any()
    tree["params"]["predictions"]["kernel"][:] = 7
    assert not tmpl["params"]["predictions"]["kernel"].any()


def test_from_keras_h5_refuses_what_jax_refuses(tmp_path):
    tmpl, keras = _seeded_layers(5)
    keras["predictions"] = [("kernel", np.zeros((8, 11), np.float32)), ("bias", np.zeros(11))]
    bad = str(tmp_path / "shape.h5")
    _write_legacy_h5(bad, keras)
    with pytest.raises(ValueError, match=r"predictions.kernel: flax \(8, 10\) vs keras \(8, 11\)"):
        tpio.from_keras_h5(bad, tmpl)
    with pytest.raises(ValueError, match=r"predictions.kernel: flax \(8, 10\) vs keras \(8, 11\)"):
        jpio.from_keras_h5(bad, tmpl)
    tmpl2, keras2 = _seeded_layers(5)
    del keras2["block_bn"]
    fewer = str(tmp_path / "fewer.h5")
    _write_legacy_h5(fewer, keras2)
    for fn in (tpio.from_keras_h5, jpio.from_keras_h5):
        with pytest.raises(ValueError, match="BatchNormalization: flax has 4 layers, keras has 3"):
            fn(fewer, tmpl2)
    import h5py

    empty = str(tmp_path / "empty.h5")
    with h5py.File(empty, "w") as f:
        f.attrs["layer_names"] = [b"input_1"]
        f.create_group("input_1").attrs["weight_names"] = []
    with pytest.raises(ValueError, match="no legacy-format layer weights"):
        tpio.load_keras_h5(empty)


# ----------------------------------------------------------------------
# Keras models with random weights (test_keras_parity through the port)
# ----------------------------------------------------------------------


def _keras():
    tf = pytest.importorskip("tensorflow")
    tf.config.set_visible_devices([], "GPU")
    # the tests share the CPU with other test processes (as torch's 2
    # threads here); TF takes every core unless told before its first use
    try:
        tf.config.threading.set_intra_op_parallelism_threads(2)
        tf.config.threading.set_inter_op_parallelism_threads(2)
    except RuntimeError:  # TF already running in this process
        pass
    return tf


def _port_probs(name, tree, x):
    module = get_model(name).build(dtype=torch.float32)
    module.load_state_dict(tpio.from_flax_variables(tree, module))
    with torch.inference_mode():
        return module.eval()(torch.from_numpy(x)).numpy()


def _assert_keras_parity(ky, py, atol, min_corr):
    assert ky.shape == py.shape == (1, 1000)
    np.testing.assert_allclose(py, ky, atol=atol)
    kc, pc = ky - ky.mean(), py - py.mean()
    corr = float((kc * pc).sum() / np.sqrt((kc * kc).sum() * (pc * pc).sum()))
    assert corr > min_corr, f"centered correlation {corr:.3f} too low"


@pytest.mark.parametrize("name", ["ResNet50", "InceptionV3"])
def test_keras_parity_and_h5_equal_live_model(name, tmp_path):
    """test_keras_parity's and test_from_keras_h5_matches_from_keras_model's
    cases: Keras's probabilities within atol 1e-6 (the JAX test's bar),
    and the legacy .h5 of the same model converts to the same tree in
    both packages."""
    tf = _keras()
    import h5py
    from keras.src.legacy.saving import legacy_h5_format

    spec = get_model(name)
    kmodel = getattr(tf.keras.applications, name)(weights=None)
    tmpl = _flax_like(name)
    tree = tpio.from_keras_model(kmodel, tmpl)
    x = np.random.default_rng(0).standard_normal((1, *spec.input_size, 3)).astype(np.float32)
    _assert_keras_parity(np.asarray(kmodel(x, training=False)), _port_probs(name, tree, x),
                         1e-6, 0.5)
    h5 = str(tmp_path / f"{name}.h5")
    with h5py.File(h5, "w") as f:
        legacy_h5_format.save_weights_to_hdf5_group(f, kmodel)
    assert_same_tree(tpio.from_keras_h5(h5, tmpl), tree)
    assert_same_tree(jpio.from_keras_h5(h5, tmpl), tree)


@pytest.mark.parametrize("name", ["ResNet101", "ResNet152"])
def test_keras_parity_deep_resnets(name):
    tf = _keras()
    spec = get_model(name)
    kmodel = getattr(tf.keras.applications, name)(weights=None)
    tree = tpio.from_keras_model(kmodel, _flax_like(name))
    x = np.random.default_rng(0).standard_normal((1, *spec.input_size, 3)).astype(np.float32)
    _assert_keras_parity(np.asarray(kmodel(x, training=False)), _port_probs(name, tree, x),
                         1e-6, 0.5)


def test_keras_parity_mobilenetv2():
    """With randomized BN statistics, as the JAX test has them (stock
    init collapses the ReLU6 chain to a uniform softmax)."""
    tf = _keras()
    spec = get_model("MobileNetV2")
    tf.keras.utils.set_random_seed(7)
    kmodel = tf.keras.applications.MobileNetV2(weights=None)
    rng = np.random.default_rng(3)
    for layer in kmodel.layers:
        if type(layer).__name__ == "BatchNormalization":
            g, b, m, v = layer.get_weights()
            layer.set_weights([
                rng.uniform(1.0, 1.8, g.shape).astype(np.float32),
                rng.normal(0, 0.1, b.shape).astype(np.float32),
                rng.normal(0, 0.1, m.shape).astype(np.float32),
                rng.uniform(0.5, 1.5, v.shape).astype(np.float32),
            ])
    tree = tpio.from_keras_model(kmodel, _flax_like("MobileNetV2"))
    x = rng.standard_normal((1, *spec.input_size, 3)).astype(np.float32)
    ky = np.asarray(kmodel(x, training=False))
    assert ky.std() > 1e-5, "keras output collapsed: comparison is vacuous"
    _assert_keras_parity(ky, _port_probs("MobileNetV2", tree, x), 1e-5, 0.99)


@pytest.mark.parametrize("size", [(128, 128), (190, 190)])
def test_keras_parity_efficientnet_b0(size):
    """At reduced input sizes; 190 px gives the odd 95 px stem map that
    Keras's correct_pad adjusts for."""
    tf = _keras()
    tf.keras.utils.set_random_seed(7)
    kmodel = tf.keras.applications.EfficientNetB0(weights=None, input_shape=(*size, 3))
    tree = tpio.from_keras_model(kmodel, _flax_like("EfficientNetB0"))
    x = np.random.default_rng(0).uniform(0, 255, (1, *size, 3)).astype(np.float32)
    _assert_keras_parity(np.asarray(kmodel(x, training=False)),
                         _port_probs("EfficientNetB0", tree, x), 2e-5, 0.5)


# ----------------------------------------------------------------------
# fixtures and checkpoints
# ----------------------------------------------------------------------


def _small_tree(seed):
    rng = np.random.RandomState(seed)
    return {"params": {"conv": {"kernel": rng.randn(3, 3, 2, 4).astype(np.float32),
                                "bias": rng.randn(4).astype(np.float32)},
                       "dense": {"kernel": rng.randn(4, 3).astype(np.float32)}},
            "batch_stats": {"bn": {"mean": rng.randn(4).astype(np.float32),
                                   "var": rng.rand(4).astype(np.float32)}}}


def test_npz_fixture_read_by_either_package(tmp_path):
    """test_imagenet_parity's `test_npz_fixture_roundtrip` both ways: the
    port's fixture is the JAX package's (its `load_npz_fixture(path,
    like)` reads it leaf for leaf, with the embedded class index), and
    the port reads the JAX package's; tensors are written as arrays."""
    tree = _small_tree(0)
    cij = json.dumps({"0": ["n01", "thing"]})
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tpio.save_npz_fixture(mine, tree, cij)
    jpio.save_npz_fixture(theirs, tree, cij)
    loaded, cij2 = jpio.load_npz_fixture(mine, tree)
    assert cij2 == cij
    assert_same_tree(tpio._tree_map(np.asarray, loaded), tree)
    for path in (mine, theirs):
        flat, cij3 = tpio.load_npz_fixture(path)
        assert cij3 == cij
        assert_same_tree(flat, _leaves(tree))
    as_tensors = tpio._tree_map(torch.from_numpy, tree)
    as_tensors["params"]["dense"]["kernel"] = as_tensors["params"]["dense"]["kernel"].bfloat16()
    tpio.save_npz_fixture(mine, as_tensors)
    flat, cij4 = tpio.load_npz_fixture(mine)
    assert cij4 is None
    np.testing.assert_array_equal(
        flat["params/dense/kernel"],
        torch.from_numpy(tree["params"]["dense"]["kernel"]).bfloat16().float().numpy())


def test_checkpoint_round_trip_and_jax_reads_it(tmp_path):
    """The port's checkpoint is one flax-msgpack file, byte for byte
    `variables_to_bytes` of the JAX package, which reads it with
    `variables_from_bytes`; it is not the JAX package's orbax checkpoint
    format, so this holds no `load_checkpoint` of one package to the
    other's `save_checkpoint`."""
    tree = _small_tree(1)
    ck = str(tmp_path / "ck")
    tpio.save_checkpoint(ck, tree)
    assert os.listdir(ck) == ["variables.msgpack"]
    assert_same_tree(tpio.load_checkpoint(ck), tree)
    with open(os.path.join(ck, "variables.msgpack"), "rb") as f:
        data = f.read()
    assert data == jpio.variables_to_bytes(tree)
    assert_same_tree(tpio._tree_map(np.asarray, jpio.variables_from_bytes(data, tree)), tree)
    # overwrite in place; `like` gives structure, shapes and numpy dtypes
    tree2 = _small_tree(2)
    tpio.save_checkpoint(ck, tpio._tree_map(torch.from_numpy, tree2))
    like = tpio._tree_map(lambda a: np.zeros(a.shape, np.float64), tree2)
    got = tpio.load_checkpoint(ck, like)
    assert got["params"]["conv"]["kernel"].dtype == np.float64
    np.testing.assert_array_equal(got["params"]["conv"]["kernel"],
                                  tree2["params"]["conv"]["kernel"])
    with pytest.raises(ValueError, match="no keys"):
        tpio.load_checkpoint(ck, {"params": {"missing": np.zeros(1)}})
    bad = tpio._tree_map(np.asarray, tree2)
    bad["params"]["dense"]["kernel"] = np.zeros((9, 9), np.float32)
    with pytest.raises(ValueError, match="shape"):
        tpio.load_checkpoint(ck, bad)


# ----------------------------------------------------------------------
# run_parity, both packages on one fixture
# ----------------------------------------------------------------------


def _record(monkeypatch, engine_cls, into):
    real = engine_cls.infer_files

    def infer_files(self, name, files, top=5):
        res = real(self, name, files, top)
        into.extend((os.path.basename(f), t) for f, t in zip(res.files, res.top5))
        return res

    monkeypatch.setattr(engine_cls, "infer_files", infer_files)


def test_run_parity_gives_the_jax_report(tmp_path, monkeypatch):
    """A seeded ResNet50 fixture (BN statistics perturbed, so the
    probabilities have a real spread) with an embedded class index, 10
    seeded JPEGs and two golden files: one the JAX engine's own top-5 on
    five images, one with its top-1 moved down on two of the other five.
    The port's run_parity (CPU engine, float32) serves the JAX engine's
    top-5 on every image (scores within 1e-4, test_torch_engine's bar)
    and reports the JAX report's agreements within 1e-6."""
    import jax.numpy as jnp
    from PIL import Image

    from dml_tpu.inference.engine import InferenceEngine as JaxEngine
    from dml_tpu.models import labels as jlabels
    from dml_tpu.models.resnet import ResNet50 as JaxResNet50
    from dml_tpu_torch.inference.engine import InferenceEngine as PortEngine
    from dml_tpu_torch.models import labels as tlabels
    from test_torch_models import jax_init, perturb_bn

    weights, images, goldens = (tmp_path / d for d in ("weights", "images", "goldens"))
    for d in (weights, images, goldens):
        d.mkdir()
    index = {str(i): [f"n{i:08d}", f"class_{i}"] for i in range(1000)}
    variables = perturb_bn(jax_init(JaxResNet50(dtype=jnp.float32), 64), seed=6)
    jpio.save_npz_fixture(str(weights / "dml_tpu_ResNet50.npz"), variables, json.dumps(index))
    rng = np.random.RandomState(8)
    names = [f"img{i}.jpeg" for i in range(10)]
    for n in names:
        Image.fromarray(rng.randint(0, 256, (96, 96, 3)).astype(np.uint8)).save(
            images / n, quality=90)
    monkeypatch.setenv("DML_TPU_KERAS_WEIGHTS_DIR", str(weights))
    for mod in (jip, tip):
        monkeypatch.setattr(mod, "GOLDEN_IMAGE_DIRS", (str(images),))
        # no download attempt: the class index comes from the fixture
        monkeypatch.setattr(mod, "_ensure_class_index", lambda: None)
    jax_top, port_top = [], []
    _record(monkeypatch, JaxEngine, jax_top)
    _record(monkeypatch, PortEngine, port_top)

    # the goldens: file 1 is the JAX engine's top-5, file 2 moves it
    je = JaxEngine(dtype=jnp.float32)
    je.load_model("ResNet50", variables=variables, batch_size=8, warmup=False)
    (weights / "index.json").write_text(json.dumps(index))
    jlabels.set_class_index_path(str(weights / "index.json"))
    try:
        own = dict(zip(names, je.infer_files("ResNet50", [str(images / n) for n in names]).top5))
    finally:
        jlabels.set_class_index_path(None)
    jax_top.clear()
    (weights / "index.json").unlink()
    g1 = {n: [[list(t) for t in own[n]]] for n in names[:5]}
    g2 = {n: [[list(t) for t in (own[n][1:] + own[n][:1] if i < 2 else own[n])]]
          for i, n in enumerate(names[5:])}
    (goldens / "output_1_127.json").write_text(json.dumps(g1))
    (goldens / "output_2_127.json").write_text(json.dumps(g2))

    try:
        want = jip.run_parity(models=("ResNet50",), golden_dir=str(goldens), dtype="float32")
    finally:
        jlabels.set_class_index_path(None)
    try:
        got = tip.run_parity(models=("ResNet50",), golden_dir=str(goldens), dtype="float32",
                             device="cpu")
    finally:
        tlabels.set_class_index_path(None)
    assert want["skipped"] is False and got["skipped"] is False, (want, got)
    assert [n for n, _ in port_top] == [n for n, _ in jax_top] == names
    for (n, t), (_, j) in zip(port_top, jax_top):
        assert [w for w, _, _ in t] == [w for w, _, _ in j], n
        np.testing.assert_allclose([s for _, _, s in t], [s for _, _, s in j], atol=1e-4)
    gv, wv = got["models"]["ResNet50"]["engine_vs_golden"], want["models"]["ResNet50"]["engine_vs_golden"]
    assert [g["golden"] for g in gv] == [g["golden"] for g in wv]
    for g, w in zip(gv, wv):
        assert g["n"] == w["n"] == 5
        for k in ("top1", "top5_overlap"):
            assert abs(g[k] - w[k]) <= 1e-6, (k, g, w)
    assert [w["top1"] for w in wv] == [1.0, 0.6]
    rest = {k: v for k, v in got.items() if k != "models"}
    assert rest == {k: v for k, v in want.items() if k != "models"}
    assert got["models"]["ResNet50"]["weights"] == want["models"]["ResNet50"]["weights"]
