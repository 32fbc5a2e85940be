"""The port's InferenceEngine rules, on the CPU: batch-size changes,
cost constants and memory, the cached-entry and explicit-weights
eviction rules of the JAX engine, the classifier width taken from the
weights, and the refusal to run without CUDA unless asked for the CPU.

Port-only: these hold the engine to the JAX engine's documented rules,
so its own seeded weights (params_io.init_variables) serve.

Kept to three test functions or fewer: pytest-xdist's loadfile scheduler
orders files by their test count, so a small count runs the port's files
last, after the cluster simulations that share fixed UDP ports.
"""

import numpy as np
import pytest
import torch

from dml_tpu_torch.inference import InferenceEngine
from dml_tpu_torch.models import get_model
from dml_tpu_torch.models.params_io import init_variables


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
    return init_variables(get_model("ResNet50"), seed=5)


def _images(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, 224, 224, 3)).astype(np.uint8)


def test_set_batch_size_cost_constants_and_memory(weights):
    port = InferenceEngine(dtype=torch.float32, device="cpu")
    port.load_model("ResNet50", variables=weights, batch_size=4)
    c = port.cost_constants("ResNet50")
    assert c["batch_size"] == 4 and c["per_query"] > 0 and c["first_query"] > 0
    imgs = _images(3, seed=4)
    want = port.infer_arrays("ResNet50", imgs)
    port.set_batch_size("ResNet50", 2)
    assert port.cost_constants("ResNet50")["batch_size"] == 2
    np.testing.assert_allclose(port.infer_arrays("ResNet50", imgs), want, atol=1e-6)
    port.set_batch_size("ResNet50", 2)  # no-op at the current size
    stats = port.memory_stats()
    assert stats["ResNet50"]["batch_size"] == 2
    assert 100 < stats["ResNet50"]["param_mb"] < 105  # 25.6M float32 values
    assert port.loaded_models == ["ResNet50"]
    with pytest.raises(KeyError):
        port.cost_constants("InceptionV3")  # not loaded
    assert port.choose_dispatch_mode([("ResNet50", imgs[:1])], rounds=1) in ("sync", "pipelined")


def test_cached_entry_and_explicit_weights_eviction(weights):
    eng = InferenceEngine(dtype=torch.float32, device="cpu")
    lm = eng.load_model("ResNet50", variables=weights, batch_size=2, warmup=False)
    # same seed, no new weights or size: the cached entry
    assert eng.load_model("ResNet50") is lm
    assert eng.load_model("resnet", batch_size=2) is lm
    # a reshape keeps the explicit weights, not a fall-through to init
    imgs = _images(1, seed=6)
    want = eng.infer_arrays("ResNet50", imgs)
    lm2 = eng.load_model("ResNet50", batch_size=3, warmup=False)
    assert lm2 is not lm and lm2.batch_size == 3 and lm2.explicit_weights
    np.testing.assert_allclose(eng.infer_arrays("ResNet50", imgs), want, atol=1e-6)
    # evicted while serving explicit weights: a lazy load refuses
    assert eng.unload_model("ResNet50")
    assert not eng.unload_model("ResNet50")
    assert eng.evicted_with_explicit_weights("ResNet50")
    with pytest.raises(RuntimeError, match="evicted while serving explicit weights"):
        eng.load_model("ResNet50", warmup=False)
    # reloading the weights clears the refusal; a reload without an
    # explicit batch size keeps the serving one
    eng.load_model("ResNet50", variables=weights, batch_size=3, warmup=False)
    assert not eng.evicted_with_explicit_weights("ResNet50")
    lm3 = eng.load_model("ResNet50", variables=eng._require("ResNet50").module.state_dict(),
                         warmup=False)
    assert lm3.batch_size == 3


def test_needs_cuda_unless_asked_and_takes_head_width_from_weights(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(device="cuda")
    eng = InferenceEngine(dtype=torch.float32, device="cpu")
    assert eng.device.type == "cpu"
    # the classifier width comes from the weights, as in the JAX engine
    sd = init_variables(get_model("ResNet50"), seed=1, num_classes=10)
    lm = eng.load_model("ResNet50", variables=sd, batch_size=2, warmup=False)
    assert lm.num_classes == 10
    assert eng.infer_arrays("ResNet50", _images(1, seed=7)).shape == (1, 10)
    del sd["conv1_bn.running_var"]
    with pytest.raises(RuntimeError, match="conv1_bn.running_var"):
        eng.load_model("ResNet50", variables=sd, warmup=False)
    del sd["predictions.bias"]
    with pytest.raises(ValueError, match="classifier head"):
        eng.load_model("ResNet50", variables=sd, warmup=False)
