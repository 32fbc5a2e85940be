"""The port's conv roofline (`dml_tpu_torch.tools.conv_roofline`) against
the JAX tool's (`dml_tpu/tools/conv_roofline.py`), on the CPU.

- The port's inventory (its models on the `meta` device under a dispatch
  mode) equals JAX's jaxpr inventory for ResNet50, InceptionV3 and
  EfficientNetB4 at batch 32: the conv count, the multiset of (lhs, rhs,
  feature groups, strides, out), `conv_gflops`, and the concat sites (15
  for InceptionV3, 0 for ResNet50). A conv's lhs is compared at its
  padded extent: JAX pads ResNet's stem (and EfficientNet's stride-2
  convs) with a `pad` before a VALID conv, where the port's ResNet stem
  pads inside the conv (`Conv2d(padding=3)`); the window the conv reads
  is the same.
- `tests/test_conv_roofline.py`'s cases run on the port (`port_cases`)
  where they hold under the H100 constants. Excluded by name:
  `test_eff_bw_classes` (it holds every class below the v5e's 750 GB/s
  stream constant and orders the v5e's classes); its counterpart holds
  the measured H100 classes below the published HBM rate (3.35 TB/s)
  and in the order the card measured them.
"""

from __future__ import annotations

import collections

import jax
import jax.numpy as jnp
import pytest

from dml_tpu.models.registry import get_model as jax_get_model
from dml_tpu_torch.tools import conv_roofline as cr
from test_torch_cluster import port_cases

globals().update(port_cases("test_conv_roofline", "conv_roofline",
                            exclude=("test_eff_bw_classes",)))

MODELS = ("ResNet50", "InceptionV3", "EfficientNetB4")


def _padded(lhs, padding):
    n, h, w, c = lhs
    (pt, pb), (pl, pr) = padding
    return (n, h + pt + pb, w + pl + pr, c)


def _jax_inventory(name, batch):
    """(conv keys, conv FLOPs, concat count) from JAX's jaxpr of the eval
    forward (weights by `jax.eval_shape`: nothing is compiled)."""
    spec = jax_get_model(name)
    model = spec.build(dtype=jnp.bfloat16)
    x1 = jnp.zeros((1, *spec.input_size, 3), jnp.bfloat16)
    v = jax.eval_shape(lambda k: model.init(k, x1, train=False), jax.random.PRNGKey(0))
    x = jax.ShapeDtypeStruct((batch, *spec.input_size, 3), jnp.bfloat16)
    jaxpr = jax.make_jaxpr(lambda v, x: model.apply(v, x, train=False))(v, x).jaxpr
    keys, flops, concats = [], 0.0, 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "conv_general_dilated":
            rhs = tuple(eqn.invars[1].aval.shape)
            out = tuple(eqn.outvars[0].aval.shape)
            keys.append((_padded(tuple(eqn.invars[0].aval.shape), eqn.params["padding"]), rhs,
                         eqn.params["feature_group_count"],
                         tuple(eqn.params["window_strides"]), out))
            kh, kw, cin_g, cout = rhs
            flops += 2.0 * out[0] * out[1] * out[2] * kh * kw * cin_g * cout
        elif eqn.primitive.name == "concatenate":
            concats += 1
    return keys, flops, concats


@pytest.mark.parametrize("name", MODELS)
def test_inventory_equals_jax_jaxpr(name):
    keys, flops, concats = _jax_inventory(name, 32)
    inv = cr.inventory(name, 32)
    got = [(_padded(c["lhs"], c["padding"]), c["rhs"], c["groups"], c["strides"], c["out"])
           for c in inv.convs]
    assert len(got) == len(keys)
    assert collections.Counter(got) == collections.Counter(keys)
    assert cr.analyze(name, 32)["conv_gflops"] == round(flops / 1e9, 1)
    assert len(inv.concats) == concats
    assert cr.concat_analysis(name, 32)["concat_sites"] == {
        "ResNet50": 0, "InceptionV3": 15, "EfficientNetB4": 0}[name]


def test_eff_bw_classes_measured_on_the_h100():
    """Counterpart of test_eff_bw_classes: every class bandwidth is
    positive and below the H100's published HBM rate (`HBM_BW`, 3.35
    TB/s: nothing streams faster), so the measured-bandwidth serial
    bound is stricter than the published-rate one; and the classes sit
    in the order the card measured them (phase 22): small-spatial dense,
    small-spatial depthwise, large depthwise, large dense. The JAX
    test's first ordering (large depthwise below small dense, a v5e
    fact) is reversed on the H100, where a small dense conv at batch 128
    costs the host's launch floor."""
    classes = {(fg, sp): cr.eff_bw(fg, sp) for fg in (1, 192) for sp in (12, 24, 48, 95, 190)}
    assert all(0 < bw < cr.HBM_BW for bw in classes.values())
    assert cr.eff_bw(1, 24) < cr.eff_bw(960, 24) < cr.eff_bw(192, 95) < cr.eff_bw(1, 95)
    r = cr.analyze("EfficientNetB4", 32)
    assert r["mfu_bound_serial_measured_bw"] < r["mfu_bound_serial"]


def test_tile_util_is_the_wgmma_granule():
    """K pads to 16 and Cout to 8 (bf16 wgmma m64nNk16): ResNet's stem,
    K = 7*7*3 = 147 of 160 and Cout 64, uses 147/160 of its tiles; a
    3x3 conv of 48 channels (K 432 = 27 x 16) and Cout 96 wastes none."""
    assert cr.tile_util(147, 64) == 147 / 160
    assert cr.tile_util(3 * 3 * 48, 96) == 1.0
    assert cr.tile_util(16, 3) == 3 / 8


@pytest.mark.parametrize("fn", [cr.microbench, cr.concat_microbench])
def test_microbenches_default_to_cuda(fn):
    """The on-card passes run on cuda unless asked for the CPU: with no
    CUDA device they raise before any work."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn("ResNet50", 1)
