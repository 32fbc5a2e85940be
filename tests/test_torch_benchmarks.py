"""The port's slope timer and MFU count (`dml_tpu_torch.benchmarks`)
against the JAX package's (`dml_tpu/benchmarks.py`), on the CPU.

- `tests/test_benchmarks.py`'s cases run on the port (`port_cases`),
  but for `test_dynamic_slope_stats_single_compile`, which tests a jit
  (one trace for both chain lengths); its counterpart here checks that
  `fn` is called with each chain length in every rep and that the slope
  is the scripted work an iteration.
- A CUDA tensor is timed by CUDA events and never by the host clock
  (the device and the events faked, the host clock made to raise).
- `poke`, and `peak_flops` by the card's name (an unknown card raises).
- `compiled_flops` equals the convolution + dense formula (2 per
  multiply-add, every output position times its full window) summed
  over the JAX forward's own jaxpr, exactly; flash attention is counted
  by formula whichever implements it. XLA's `cost_analysis`, which the
  JAX `compiled_flops` reads, counts less: the ratios measured on the
  CPU (0.8838 for ResNet50 at batch 2, 64x64; 0.8083 for InceptionV3 at
  batch 2, 75x75, float32) are pinned within +-0.01. Weights are the
  JAX module's tree (`jax.eval_shape` of its init, filled from a numpy
  seed), carried to the port by `params_io.from_flax_variables`.
"""

from __future__ import annotations

import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_tpu import benchmarks as jbm
from dml_tpu.models.registry import get_model as jax_get_model
from dml_tpu_torch import benchmarks as bm
from dml_tpu_torch.models.params_io import from_flax_variables
from dml_tpu_torch.models.registry import get_model
from dml_tpu_torch.ops.flash_attention import flash_attention
from test_torch_cluster import port_cases

globals().update(port_cases("test_benchmarks", "benchmarks",
                            exclude=("test_dynamic_slope_stats_single_compile",)))

#: XLA's FLOP count over the port's, on the CPU (float32)
XLA_RATIO = {"ResNet50": (64, 0.884), "InceptionV3": (75, 0.808)}
RATIO_TOL = 0.01


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_dynamic_slope_stats_calls_each_length_and_measures_the_slope():
    """Counterpart of test_dynamic_slope_stats_single_compile: the body
    runs n iterations of 2 ms each; every rep calls it at both lengths,
    short then long, after one settling call of each, and the slope is
    the 2 ms an iteration."""
    calls = []

    def chain(n, x):
        calls.append(n)
        time.sleep(n * 2e-3)
        return x.sum()

    st = bm.dynamic_slope_stats(chain, (torch.ones(8, 8),), lengths=(2, 22), reps=3)
    assert calls == [2, 22] * 4
    assert st["reps"] == 3 and "degenerate_reps" not in st
    assert 1.5e-3 < st["median"] < 3e-3
    assert st["min"] <= st["median"] <= st["max"]


def test_cuda_tensors_are_timed_by_events_never_the_host_clock(monkeypatch):
    """A chain over a CUDA tensor is timed between two CUDA events: with
    the device and the events faked, and the host clock raising, the
    slope comes from the events' elapsed times (1 ms short, 3 ms long,
    10 iterations apart: 0.2 ms an iteration)."""
    elapsed = iter([1.0, 3.0] * 3)
    recorded = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.ms = None

        def record(self):
            recorded.append(self)

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return next(elapsed)

    def no_host_clock():
        raise AssertionError("a CUDA chain read the host clock")

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(bm, "time", types.SimpleNamespace(monotonic=no_host_clock))
    monkeypatch.setattr(bm, "_device_of", lambda args: torch.device("cuda", 0))
    st = bm._paired_slopes(lambda: None, lambda: None, (), 10, 20, 2)
    assert len(recorded) == 2 * 2 * 3  # start and end of each of 6 chains
    assert st == {"median": pytest.approx(2e-4), "min": pytest.approx(2e-4),
                  "max": pytest.approx(2e-4), "reps": 2}


def test_device_of_finds_the_tensors_device():
    assert bm._device_of((1, {"a": [torch.zeros(2)]})).type == "cpu"
    assert bm._device_of(()).type == "cpu"


def test_poke_writes_the_carry_parity_in_place():
    for dtype in (torch.uint8, torch.bfloat16, torch.float32):
        x = torch.full((2, 3, 3), 7, dtype=dtype)
        assert bm.poke(x, torch.tensor(3.0)) is x
        assert x[0, 0, 0].item() == 1 and (x.reshape(-1)[1:] == 7).all()
        bm.poke(x, torch.tensor(4.0))
        assert x[0, 0, 0].item() == 0


@pytest.mark.parametrize("name,peak", [("NVIDIA H100 80GB HBM3", 989e12),
                                       ("NVIDIA H100 PCIe", None), ("TPU v5 lite", None)])
def test_peak_flops_by_card_name(monkeypatch, name, peak):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    if peak is None:
        with pytest.raises(ValueError, match="no published peak"):
            bm.peak_flops()
    else:
        assert bm.peak_flops() == peak


def _jax_forward_and_weights(name, size):
    spec = jax_get_model(name)
    model = spec.build(dtype=jnp.float32)
    x = jnp.zeros((2, size, size, 3), jnp.float32)
    shapes = jax.eval_shape(lambda k: model.init(k, x[:1], train=False), jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(
        lambda s: rng.normal(0.0, 0.05, s.shape).astype(np.float32), shapes)
    return (lambda v, b: model.apply(v, b, train=False)), variables, x


def _formula_flops(jaxpr) -> float:
    """2 per multiply-add of every convolution and dense product in the
    jaxpr: each output position times its full window."""
    total = 0.0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "conv_general_dilated":
            kh, kw, cin_g, cout = eqn.invars[1].aval.shape
            n, ho, wo, _ = eqn.outvars[0].aval.shape
            total += 2.0 * n * ho * wo * kh * kw * cin_g * cout
        elif eqn.primitive.name == "dot_general":
            (lc, _rc), _ = eqn.params["dimension_numbers"]
            k = int(np.prod([eqn.invars[0].aval.shape[d] for d in lc]))
            total += 2.0 * int(np.prod(eqn.outvars[0].aval.shape)) * k
        for sub in jax.core.jaxprs_in_params(eqn.params):
            total += _formula_flops(sub)
    return total


@pytest.mark.parametrize("name", sorted(XLA_RATIO))
def test_compiled_flops_is_the_formula_and_xla_counts_less(name):
    size, ratio = XLA_RATIO[name]
    fwd, variables, x = _jax_forward_and_weights(name, size)
    formula = _formula_flops(jax.make_jaxpr(fwd)(variables, x).jaxpr)
    model = get_model(name).build(dtype=torch.float32)
    model.load_state_dict(from_flax_variables(variables, model))
    got = bm.compiled_flops(lambda m, b: m(b), model.eval(), torch.zeros(2, size, size, 3))
    assert got == formula
    xla = jbm.compiled_flops(fwd, variables, x)
    assert xla / got == pytest.approx(ratio, abs=RATIO_TOL)


def test_flash_attention_flops_whichever_implements_it(monkeypatch):
    """K2 is a ctypes launch no aten op sees: counted by formula, the same
    whether the plain version (matrix products the counter sees) or a
    kernel (nothing it sees) computes it."""
    from dml_tpu_torch.ops import flash_attention as fa

    b, t, h, d = 2, 24, 4, 8
    w = torch.randn(h * d, h * d)
    x = torch.randn(b, t, h * d)

    def fwd(w, x):
        q = (x @ w).reshape(b, t, h, d)
        kv = x.reshape(b, t, h, d)
        return flash_attention(q, kv, kv, causal=False)

    want = 2.0 * b * t * (h * d) ** 2 + bm.attention_flops(b, t, t, h, d)
    assert bm.compiled_flops(fwd, w, x) == want

    def kernel_like(q, k, v, causal, scale):  # no aten op the counter counts
        return torch.zeros_like(q), torch.zeros(q.shape[0], q.shape[2], q.shape[1])

    monkeypatch.setattr(fa, "_forward", kernel_like)
    assert bm.compiled_flops(fwd, w, x) == want
