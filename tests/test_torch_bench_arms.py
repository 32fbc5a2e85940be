"""The port's one-device bench arms of `inference.lm_sharded`
(`bench_specdec_arm`, `bench_cb_arm`) against the JAX package's, on the
CPU, at a small float32 LM of `test_torch_lm_sharded.py`'s ShardLM shape
on the JAX package's seeded weights (written with the flax-msgpack codec
and named in the port's spec, `"weights"`, as `from_flax_variables`
carries them).

- The isolated `generate` continuations that both arms hold their
  servers to are equal token for token across the packages.
- Equal across the packages: `outputs_equal` (true in both),
  `accept_rate` (the oracle proposer's, at the declared rate), the
  auto-disable verdict (`disabled`, `reason`, `outputs_equal`; the
  draft's own weights are each package's seeded init, so its
  acceptance rate is not compared), and the continuous-batching arm's
  `outputs_equal`. Timing fields are not compared.
- The cluster benches that wait for the rank-driven group form raise
  NotImplementedError naming it: `bench_lm_sharded_serving` and
  `lm_sharded._main`, `jobs.groups.bench_sharded_serving` and
  `jobs.groups._main`.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from dml_tpu.inference import lm_sharded as jls
from dml_tpu.inference.lm_backend import lm_spec_parts as jax_lm_spec_parts
from dml_tpu.models import params_io as jpio
from dml_tpu_torch.inference import lm_sharded as tls
from dml_tpu_torch.inference.lm_backend import lm_spec_parts
from dml_tpu_torch.jobs import groups as tgroups

SPEC = {"name": "ShardLM", "vocab_size": 64, "d_model": 32, "n_heads": 4, "n_kv_heads": 2,
        "n_layers": 2, "d_ff": 64, "dtype": "float32", "max_new_tokens": 8, "max_slots": 2,
        "max_len": 64, "chunk": 4, "seed": 0}
SPECDEC = dict(n_prompts=4, new_tokens=12)
CB = dict(n_waves=3, new_tokens=6)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    """(JAX params, cfg), (port params, cfg) on the same weights."""
    jp, jc = jax_lm_spec_parts(SPEC)
    path = tmp_path_factory.mktemp("arms") / "shardlm.msgpack"
    path.write_bytes(jpio.variables_to_bytes({"params": jax.tree_util.tree_map(np.asarray, jp)}))
    return (jp, jc), lm_spec_parts(dict(SPEC, weights=str(path)), device="cpu")


def _arms(parts, jax_arm, port_arm, kw):
    """Both packages' arm on the same weights, with the isolated
    `generate` continuations each computed as its references (as Python
    ints, in call order)."""
    import dml_tpu.inference.generate as jgen

    (jp, jc), (tp, tc) = parts
    refs = {"jax": [], "port": []}

    def recording(fn, into, row):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            into.append([int(t) for t in row(out)])
            return out
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgen, "generate", recording(jgen.generate, refs["jax"],
                                               lambda o: np.asarray(o)[0]))
        mp.setattr(tls, "generate", recording(tls.generate, refs["port"],
                                              lambda o: o[0].tolist()))
        want = jax_arm(jp, jc, SPEC, **kw)
        got = port_arm(tp, tc, SPEC, device="cpu", **kw)
    return want, got, refs


@pytest.fixture(scope="module")
def specdec(parts):
    return _arms(parts, jls.bench_specdec_arm, tls.bench_specdec_arm, SPECDEC)


@pytest.fixture(scope="module")
def cb(parts):
    return _arms(parts, jls.bench_cb_arm, tls.bench_cb_arm, CB)


@pytest.mark.parametrize("arm", ["specdec", "cb"])
def test_generate_references_equal_across_packages(request, arm):
    _want, _got, refs = request.getfixturevalue(arm)
    n = SPECDEC["n_prompts"] if arm == "specdec" else 2 * CB["n_waves"]
    assert len(refs["port"]) == len(refs["jax"]) == n
    assert refs["port"] == refs["jax"]


def test_specdec_arm_verdicts_equal_across_packages(specdec):
    want, got, _refs = specdec
    assert got["outputs_equal"] is want["outputs_equal"] is True
    assert got["accept_rate"] == want["accept_rate"]
    assert got["spec_rounds"] == want["spec_rounds"]
    for key in ("draft_layers", "disabled", "reason", "outputs_equal"):
        assert got["auto_disable"][key] == want["auto_disable"][key], key
    assert got["auto_disable"]["disabled"] is True
    assert got["auto_disable"]["reason"] == "acceptance"
    assert set(got) == set(want)


def test_cb_arm_outputs_equal_across_packages(cb):
    want, got, _refs = cb
    assert got["outputs_equal"] is want["outputs_equal"] is True
    assert set(got) == set(want)
    assert got["ttft_p99_overlap_ms"] > 0 and got["ttft_p99_drain_ms"] > 0


def test_pctl_is_jaxs():
    for vals in ([], [3.0], [5.0, 1.0, 2.0], list(np.random.RandomState(0).rand(7))):
        for p in (0, 50, 99, 100):
            assert tls._pctl(list(vals), p) == jls._pctl(list(vals), p)


@pytest.mark.parametrize("arm", [tls.bench_specdec_arm, tls.bench_cb_arm])
def test_arms_default_to_cuda(parts, arm):
    """The arms run on cuda unless asked for the CPU: with no CUDA device
    they raise before any work."""
    (_jp, _jc), (tp, tc) = parts
    with pytest.raises(RuntimeError, match="no CUDA device"):
        arm(tp, tc, SPEC)


@pytest.mark.parametrize("fn", [tls.bench_lm_sharded_serving, tls._main,
                                tgroups.bench_sharded_serving, tgroups._main],
                         ids=["bench_lm_sharded_serving", "lm_sharded_main",
                              "bench_sharded_serving", "groups_main"])
def test_cluster_benches_wait_for_the_rank_driven_form(fn):
    with pytest.raises(NotImplementedError, match="ROADMAP §A item 2, the rank-driven group form"):
        fn()
