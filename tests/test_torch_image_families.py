"""The port's MobileNetV2, EfficientNet and ViT families against the JAX
package's on the CPU, same weights.

The weights are the JAX module's tree: its layout and shapes from its
`init` (traced with `jax.eval_shape`), its values drawn with numpy from
a seed, so both packages get the same tree and the port converts it with
`params_io.from_flax_variables`. Kernels are normal with variance 1 /
fan-in, as lecun-normal draws them; every bias, BN statistic, BN and
LayerNorm scale and the cls token get seeded values where Flax's init
would hide a mistake (a zero bias, mean 0 and var 1, a zero cls token);
BN as `test_torch_models.perturb_bn` draws it. (Compiling `init` took
7-12 s a model on the CPU, `eval_shape` about 1 s.)

Tolerances (those of test_torch_models.py):
- float32: probabilities within atol 1e-4 and the same top-5;
- bfloat16 against JAX bfloat16: the same top-1 and probabilities within
  5e-2 (the two CPU backends round bf16 products in other orders);
- the space-to-depth stem against the stock stem, and ViT over the flash
  hook against ViT over the dense reference attention: atol 2e-5 in
  float32 (the bars of tests/test_models.py and tests/test_vit.py);
- one train step (`parallel.train.make_train_step`, which the Trainer
  runs) against the JAX package's `make_train_step` under SGD at lr
  1e-3, float32: the loss within 1e-5 relative, parameters within atol
  2e-5, running statistics within 1e-5 relative
  (`test_torch_train.assert_state_close`). MobileNetV2 is the
  exception: its ReLU6 follows a BatchNorm that, in training, normalizes
  its deep stages over 16 values a channel, where Flax's variance
  max(0, E[x^2] - E[x]^2) loses digits that the port's two-pass sum
  keeps (measured: one head BN output 4.8e-4 apart, one ReLU6 mask
  flipped). A flipped mask moves the gradient of every layer below it:
  Conv1's update was 2.4% apart at seed 13, and the port's own float32
  step is 1.6% apart from its float64 step there. So MobileNetV2's step
  holds the loss, the running statistics and the dense head at the bars
  above, and every other update within 10% of its tensor's largest
  (measured: at most 4.4%).

Sizes are cut for the CPU: ViT at patch 8 and width 64 (tests/test_vit.py)
and ViT-Ti16 at 224 through both engines; EfficientNet-B0 at 96 and 97;
EfficientNet-B4's widths (depth 1) at 67 pixels, where its stride-2 maps
are odd; B0's blocks at width 0.25 and depth 0.5 for the train step. The
full-size models run on the card (chip_smoke.py, phase 19).

Kept to three test functions, each parametrized (see test_torch_models).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dml_tpu.inference.engine import InferenceEngine as JaxEngine
from dml_tpu.models import efficientnet as jax_effnet
from dml_tpu.models.mobilenet import MobileNetV2 as JaxMobileNetV2
from dml_tpu.models.preprocess import normalize_on_device as jax_normalize
from dml_tpu.models.registry import get_model as jax_get_model
from dml_tpu.models.vit import ViT as JaxViT
from dml_tpu.models.vit import ViT_Ti16 as JaxViT_Ti16
from dml_tpu.parallel import train as jax_train
from dml_tpu_torch.inference import InferenceEngine
from dml_tpu_torch.models import efficientnet, params_io
from dml_tpu_torch.models.mobilenet import MobileNetV2
from dml_tpu_torch.models.preprocess import normalize_on_device
from dml_tpu_torch.models.registry import MODEL_REGISTRY, get_model
from dml_tpu_torch.models.vit import ViT
from dml_tpu_torch.ops.flash_attention import flash_attention
from dml_tpu_torch.parallel import train
from test_torch_models import assert_f32_parity, images, perturb_bn
from test_torch_train import _host, assert_state_close

NARROW_VIT = dict(patch=8, hidden=64, n_layers=2, n_heads=2, mlp_dim=128, num_classes=10)
CLASSES = 10
FAMILIES = ("MobileNetV2", "EfficientNetB0", "EfficientNetB4", "ViT-B16", "ViT-S16", "ViT-Ti16")
#: EfficientNet (width, depth) by test model
EFFNET = {"effnet_b0": (1.0, 1.0), "effnet_b4w": (jax_effnet.VARIANTS["b4"][0], 1.0),
          "effnet_narrow": (0.25, 0.5)}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the tests run beside other test processes on a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def seeded_variables(jax_model, size, seed):
    """The JAX module's variables tree (numpy), values from a numpy seed."""
    shapes = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3), jnp.float32), train=False))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            x = rng.normal(0, 1, shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            x = rng.uniform(0.5, 1.5, shape)
        elif name == "pos_embed":
            x = rng.normal(0, 0.02, shape)
        else:  # bias, cls_token; BN statistics are perturb_bn's
            x = rng.normal(0, 0.2, shape)
        return x.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes["params"])
    if "batch_stats" not in shapes:
        return {"params": params}
    stats = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes["batch_stats"])
    return perturb_bn({"params": params, "batch_stats": stats}, seed)


def _pair(family, jdt, tdt, **kw):
    """(JAX model, port model) of one family at the test's widths."""
    if family == "mobilenet":
        return (JaxMobileNetV2(num_classes=CLASSES, dtype=jdt),
                MobileNetV2(num_classes=CLASSES, dtype=tdt))
    if family in EFFNET:
        w = EFFNET[family]
        return (jax_effnet.EfficientNet(*w, num_classes=CLASSES, dtype=jdt, **kw),
                efficientnet.EfficientNet(*w, num_classes=CLASSES, dtype=tdt, **kw))
    attention = flash_attention if family == "vit_flash" else None
    return JaxViT(**NARROW_VIT, dtype=jdt), ViT(**NARROW_VIT, dtype=tdt, attention=attention,
                                                image_size=(32, 32))


def run_jax(model, variables, imgs, mode, dtype):
    fwd = jax.jit(lambda v, x: model.apply(v, jax_normalize(x, mode, dtype), train=False))
    return np.asarray(fwd(variables, jnp.asarray(imgs)))


def run_port(model, variables, imgs, mode, dtype):
    model.load_state_dict(params_io.from_flax_variables(variables, model))
    model = model.eval().to(memory_format=torch.channels_last)
    with torch.inference_mode():
        out = model(normalize_on_device(torch.from_numpy(imgs), mode, dtype)).numpy()
    assert out.dtype == np.float32
    return out


# ---- forwards ----

@pytest.mark.parametrize("family,size,dtype", [
    ("mobilenet", 64, "float32"), ("mobilenet", 67, "float32"), ("mobilenet", 64, "bfloat16"),
    ("effnet_b0", 96, "float32"), ("effnet_b0", 97, "float32"), ("effnet_b0", 96, "bfloat16"),
    ("effnet_b4w", 67, "float32"),
    ("vit_dense", 32, "float32"), ("vit_flash", 32, "float32"), ("vit_flash", 32, "bfloat16"),
    ("vit_ti16_engine", 224, "float32"),
])
def test_forward_matches_jax(family, size, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    mode = "raw" if family in EFFNET else "tf"
    imgs = images(3, size, seed=size)
    if family == "vit_ti16_engine":
        # both engines, registry-built, at the full 224x224 (pos_embed 197)
        v = seeded_variables(JaxViT_Ti16(dtype=jnp.float32), 224, seed=7)
        je = JaxEngine(dtype=jnp.float32)
        je.load_model("ViT-Ti16", variables=v, batch_size=2, warmup=False)
        te = InferenceEngine(dtype=torch.float32, device="cpu")
        te.load_model("ViT-Ti16", variables=v, batch_size=2, warmup=False)
        assert te._models["ViT-Ti16"].num_classes == 1000  # from head.bias
        assert_f32_parity(np.asarray(je.infer_arrays("ViT-Ti16", imgs)),
                          te.infer_arrays("ViT-Ti16", imgs))
        return
    jm, tm = _pair(family, jdt, tdt)
    v = seeded_variables(_pair(family, jnp.float32, torch.float32)[0], size, seed=size)
    pj, pt = run_jax(jm, v, imgs, mode, jdt), run_port(tm, v, imgs, mode, tdt)
    assert pt.shape == pj.shape == (3, CLASSES)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(pt.argmax(-1), pj.argmax(-1))
        np.testing.assert_allclose(pt, pj, atol=5e-2, rtol=0)
        return
    assert_f32_parity(pj, pt)
    if family == "effnet_b0":
        # the space-to-depth stem: the same function on the same stem_conv.weight
        s2d = run_port(_pair(family, jdt, tdt, s2d_stem=True)[1], v, imgs, mode, tdt)
        np.testing.assert_allclose(s2d, pt, atol=2e-5, rtol=0)
    if family == "vit_flash":
        # the flash hook against the dense reference attention, same weights
        dense = run_port(_pair("vit_dense", jdt, tdt)[1], v, imgs, mode, tdt)
        np.testing.assert_allclose(pt, dense, atol=2e-5, rtol=0)


# ---- weights, the registry, and what raises ----

@pytest.mark.parametrize("case", ["registry", "round_trip", "init", "refusals"])
def test_weights_and_registry(case):
    if case == "registry":
        for name in FAMILIES:
            want, got = jax_get_model(name), get_model(name)
            assert (got.name, got.input_size, got.preprocess, got.aliases,
                    got.spatial_invariant) == (want.name, want.input_size, want.preprocess,
                                               want.aliases, want.spatial_invariant)
            assert got.cost.__dict__ == want.cost.__dict__
            assert all(get_model(a) is got for a in got.aliases)
        assert {s.name for s in MODEL_REGISTRY.values()} == {
            "ResNet50", "ResNet101", "ResNet152", "InceptionV3", *FAMILIES}
        vit = get_model("vitb16").build(dtype=torch.bfloat16)
        assert vit.block_0.attention is flash_attention
        assert vit.pos_embed.shape == (1, 197, 768) and vit.head.weight.dtype == torch.float32
        trained = get_model("effnetb4").build(dtype=torch.bfloat16, param_dtype=torch.float32)
        assert trained.stem_conv.weight.dtype == torch.float32
        assert trained.block2a_dwconv.weight.shape == (144, 1, 3, 3)
        assert trained.block2a_se_reduce.weight.shape == (6, 144, 1, 1)  # 0.25 x filters_in 24
    elif case == "round_trip":
        # ViT's layer-less parameters, and an asymmetric depthwise kernel
        # (an H/W or in/out swap would move its values)
        v = seeded_variables(JaxViT(**NARROW_VIT, dtype=jnp.float32), 32, seed=3)
        model = ViT(**NARROW_VIT, dtype=torch.float32, image_size=(32, 32))
        sd = params_io.from_flax_variables(v, model)
        torch.testing.assert_close(sd["pos_embed"], torch.from_numpy(v["params"]["pos_embed"]))
        back = params_io.to_flax_variables(sd, model)
        assert set(back) == {"params"}
        jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
                               back["params"], v["params"])
        k = np.arange(5 * 5 * 8, dtype=np.float32).reshape(5, 5, 1, 8)
        dw = params_io.from_flax_variables({"params": {"dw": {"kernel": k}}})["dw.weight"]
        assert dw.shape == (8, 1, 5, 5) and float(dw[2, 0, 1, 3]) == k[1, 3, 0, 2]
        np.testing.assert_array_equal(params_io.to_flax_variables(
            {"dw.weight": dw})["params"]["dw"]["kernel"].numpy(), k)
    elif case == "init":
        # one seed, one set of weights, drawn from the seed's generator alone
        spec = get_model("ViT-Ti16")
        a = params_io.init_variables(spec, seed=5)
        torch.manual_seed(123)
        b = params_io.init_variables(spec, seed=5)
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
        assert float(a["pos_embed"].std()) == pytest.approx(0.02, rel=0.05)
        assert not a["cls_token"].any() and torch.equal(a["block_0.ln_attn.weight"],
                                                        torch.ones(192))
        assert not torch.equal(a["pos_embed"], params_io.init_variables(spec, seed=6)["pos_embed"])
        engines = [InferenceEngine(dtype=torch.float32, device="cpu") for _ in range(2)]
        x = images(2, 224)
        for e in engines:
            e.load_model("ViT-Ti16", seed=5, batch_size=2, warmup=False)
        np.testing.assert_array_equal(*(e.infer_arrays("ViT-Ti16", x) for e in engines))
    else:
        model = ViT(**NARROW_VIT, dtype=torch.float32, image_size=(32, 32))
        with pytest.raises(ValueError, match="gives 37 tokens.*pos_embed holds 17"):
            model(torch.zeros(1, 48, 48, 3))
        # the module's default attention is the plain version, for CPU tensors only
        q = torch.zeros(1, 4, 2, 16, device="meta")
        with pytest.raises(RuntimeError, match="plain version, for CPU tensors"):
            model.block_0.attention(q, q, q, causal=False)
        with pytest.raises(KeyError, match="registered: .*ViT-B16"):
            get_model("EfficientNetB7")


# ---- training ----

@pytest.mark.parametrize("family", ["mobilenet", "effnet_narrow", "vit_flash", "vit_trainer"])
def test_train_step_matches_jax(family, tmp_path):
    size = 32 if family.startswith("vit") else 64
    x, y = images(4, size, seed=11), np.random.RandomState(11).randint(0, CLASSES, 4)
    if family == "vit_trainer":
        # the Trainer with no batch_stats: state, checkpoint and export
        v = seeded_variables(JaxViT_Ti16(num_classes=CLASSES, dtype=jnp.float32), 224, seed=8)
        x = images(2, 224, seed=12)
        tr = train.Trainer("ViT-Ti16", batch_size=2, dtype=torch.float32, num_classes=CLASSES,
                           variables=v, learning_rate=1e-3, device="cpu")
        first = tr.step(x, y[:2])["loss"]
        assert tr.state["batch_stats"] == {} and np.isfinite(first)
        tr.save_checkpoint(str(tmp_path))
        ahead = [tr.step(x, y[:2])["loss"] for _ in range(2)]
        assert tr.restore_checkpoint(str(tmp_path)) == 1
        assert [tr.step(x, y[:2])["loss"] for _ in range(2)] == ahead
        eng = InferenceEngine(dtype=torch.float32, device="cpu")
        eng.load_model("ViT-Ti16", variables=tr.export_variables(), batch_size=2, warmup=False)
        tr.model.eval()
        with torch.no_grad():
            want = tr.model(normalize_on_device(torch.from_numpy(x), "tf", torch.float32)).numpy()
        np.testing.assert_allclose(eng.infer_arrays("ViT-Ti16", x), want, atol=1e-6)
        return
    mode = "raw" if family in EFFNET else "tf"
    jm, tm = _pair(family, jnp.float32, torch.float32)
    v = seeded_variables(jm, size, seed=13)
    lr = 1e-3
    opt = optax.sgd(lr)
    state = {"params": v["params"], "batch_stats": v.get("batch_stats", {}),
             "opt_state": opt.init(v["params"]), "step": jnp.zeros((), jnp.int32)}
    state, m = jax.jit(jax_train.make_train_step(jm, mode, opt, jnp.float32))(
        state, jnp.asarray(x), jnp.asarray(y))
    tm.load_state_dict(params_io.from_flax_variables(v))
    tm = tm.to(memory_format=torch.channels_last)
    step = train.make_train_step(tm, mode, torch.optim.SGD(tm.parameters(), lr=lr),
                                 torch.float32)
    got = step(torch.from_numpy(x), torch.from_numpy(y))
    assert abs(float(got["loss"]) - float(m["loss"])) <= 1e-5 * abs(float(m["loss"]))
    assert float(got["accuracy"]) == float(m["accuracy"])
    params = {n: p.detach() for n, p in tm.named_parameters()}
    stats = {n: b for n, b in tm.named_buffers() if "running" in n}
    if family != "mobilenet":
        assert_state_close({"params": params, "batch_stats": stats, "step": 1}, state, set(),
                           steps=1, lr=lr)
        return
    # MobileNetV2: the running statistics and the head as above; below
    # the head's ReLU6 each update within 10% of its tensor's largest
    # (see the module docstring)
    assert_state_close({"params": {}, "batch_stats": stats, "step": 1}, state, set(), 1, lr)
    start, want = params_io.params_from_flax(v["params"]), params_io.params_from_flax(
        _host(state["params"]))
    for n, p in params.items():
        d = float((p - want[n]).abs().max())
        bar = 2e-5 if n.startswith("predictions") else (
            2e-5 + 0.1 * float((want[n] - start[n]).abs().max()))
        assert d <= bar, (n, d, bar)
