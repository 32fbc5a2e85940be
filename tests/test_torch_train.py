"""The port's image training (`dml_tpu_torch.parallel.train`) against the
JAX package's (`dml_tpu.parallel.train`) on the CPU.

The JAX side runs on a one-device mesh of the tests' 8 virtual CPU
devices (the same global-batch semantics as `local_mesh(dp=8)`: its
BatchNorm statistics are the whole batch's), its normalize the jnp
`normalize_on_device`, as the JAX package's own tests run it. The port
runs on `device="cpu"`, where `normalize_sharded` is the plain version.
Weights come from the JAX init (`init_variables` / `model.init`) and
cross with `from_flax_variables`; inputs are seeded numpy.

The models: TinyNet (the JAX test model, `tests/_tinynet.py`: a stride-2
SAME conv, BatchNorm momentum 0.9, a second conv, a dense head; its port
counterpart is defined here and registered in the port's registry for
this module), and a narrow ResNet (depths 1,1,1,1: BN eps 1.001e-5,
momentum 0.99) at 32x32.

Tolerances, float32 (the same math in another summation order):
- losses within 1e-5 relative (measured: 6.6e-7 over TinyNet's 4 steps);
- parameters within atol 2e-5 (measured 1.9e-6 on TinyNet after 4 AdamW
  steps at lr 1e-2), except the bias of a conv that feeds a BatchNorm:
  BN removes it, so its gradient is rounding noise around 0, and AdamW,
  whose first steps move each parameter by about lr * sign(g), turns
  that noise into steps of lr in either sign in both packages (measured
  0.046 = 4.6 lr after 4 steps). Those are held to 2 lr a step. A
  running mean moves with that bias, so it is held to the largest bias
  difference plus 1e-5; running variances to 1e-5 relative.
- The narrow ResNet's step runs under plain SGD at lr 1e-3 on both sides
  (the step takes any optimizer in both packages): under AdamW the same
  sign flips reach conv weights and dead channels' BN shifts at ResNet
  width (measured 1.9 lr after one step), which would hide a wrong
  gradient. Measured over 3 steps: losses within 4.3e-6 relative.
- bfloat16 (the narrow ResNet): the first step's loss within 1e-2
  relative (measured 3.7e-3: the two CPU backends round the bf16 convs
  in other orders), as for the LM's bf16 step; the running statistics
  after it within 1e-2 of their largest magnitude (or 1e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from _tinynet import ensure_tinynet
from dml_tpu.config import MeshSpec
from dml_tpu.models.inception import InceptionV3 as JaxInceptionV3
from dml_tpu.models.params_io import init_variables as jax_init_variables
from dml_tpu.models.resnet import ResNet as JaxResNet
from dml_tpu.models.resnet import ResNet50 as JaxResNet50
from dml_tpu.parallel.mesh import make_mesh
from dml_tpu.parallel import train as jax_train
from dml_tpu_torch.inference import InferenceEngine
from dml_tpu_torch.models.layers import BatchNorm, Conv2d
from dml_tpu_torch.models.params_io import (
    from_flax_variables, image_train_state_from_flax, params_from_flax,
)
from dml_tpu_torch.models.registry import MODEL_REGISTRY, CostDefaults, ModelSpec, get_model, register
from dml_tpu_torch.models.resnet import ResNet
from dml_tpu_torch.parallel import train

BATCH, CLASSES, LR = 8, 10, 1e-2


class TinyNet(nn.Module):
    """tests/_tinynet.py's TinyNet in PyTorch. Flax's SAME pad of a
    stride-2 3x3 conv on an even input is (0, 1), not 1 on each side."""

    def __init__(self, num_classes=1000, dtype=torch.float32, param_dtype=None):
        super().__init__()
        pd = dtype if param_dtype is None else param_dtype
        self.dtype = dtype
        self.c1 = Conv2d(3, 8, 3, stride=2, dtype=pd, compute_dtype=dtype)
        self.bn1 = BatchNorm(8, 1e-5, momentum=0.9)
        self.c2 = Conv2d(8, 16, 3, stride=2, dtype=pd, compute_dtype=dtype)
        self.predictions = nn.Linear(16, num_classes)

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.c1(F.pad(x, (0, 1, 0, 1)))))
        x = F.relu(self.c2(F.pad(x, (0, 1, 0, 1))))
        return torch.softmax(self.predictions(x.mean(dim=(2, 3)).float()), dim=-1)


@pytest.fixture(autouse=True, scope="module")
def _setup():
    # the tests run beside other test processes on a shared CPU; torch's
    # default of one thread per core oversubscribes it
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    ensure_tinynet()
    register(ModelSpec(name="TinyNet", builder=TinyNet, input_size=(32, 32), preprocess="unit",
                       cost=CostDefaults(load_time=0.1, first_query=0.1, per_query=0.01,
                                         default_batch_size=4)))
    yield
    MODEL_REGISTRY.pop("tinynet", None)
    torch.set_num_threads(n)


def _mesh():
    return make_mesh(MeshSpec(dp=1), devices=jax.devices()[:1])


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _batch(seed=0, n=BATCH, size=32):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, size, size, 3)).astype(np.uint8),
            rng.randint(0, CLASSES, n).astype(np.int32))


def _tiny_variables():
    return _host(jax_init_variables(get_jax_spec(), seed=0, dtype=jnp.float32,
                                    num_classes=CLASSES))


def get_jax_spec():
    from dml_tpu.models.registry import get_model as jax_get_model

    return jax_get_model("TinyNet")


def _pair(**kw):
    v = _tiny_variables()
    jt = jax_train.Trainer("TinyNet", _mesh(), batch_size=BATCH, dtype=jnp.float32,
                           num_classes=CLASSES, variables=v, learning_rate=LR, **kw)
    tr = train.Trainer("TinyNet", batch_size=BATCH, dtype=torch.float32, num_classes=CLASSES,
                       variables=v, learning_rate=LR, device="cpu", **kw)
    return jt, tr


def _pre_bn_conv_biases(model):
    """Names of the conv biases that a BatchNorm follows (TinyNet's c1;
    every ResNet conv)."""
    names = [n for n, _ in model.named_parameters()]
    return {n for n in names if n.endswith(".bias") and (
        n == "c1.bias" or n.endswith("_conv.bias"))}


def assert_state_close(state, jax_state, noisy, steps, lr):
    """The port's Trainer state against the JAX one's, converted, at the
    module docstring's tolerances."""
    js = _host(jax_state)
    want = {"params": params_from_flax(js["params"]),
            "batch_stats": params_from_flax(js["batch_stats"], "batch_stats"),
            "step": int(js["step"])}
    drift = 0.0
    for n, p in state["params"].items():
        d = float((p - want["params"][n]).abs().max())
        if n in noisy:
            assert d <= 2 * lr * steps, (n, d)
            drift = max(drift, d)
        else:
            assert d <= 2e-5, (n, d)
    for n, s in state["batch_stats"].items():
        d = float((s - want["batch_stats"][n]).abs().max())
        if n.endswith("running_mean"):
            assert d <= drift + 1e-5, (n, d, drift)
        else:
            assert d <= 1e-5 * max(1.0, float(want["batch_stats"][n].abs().max())), (n, d)
    assert state["step"] == want["step"]


# ---- BatchNorm in training mode ----

@pytest.mark.parametrize("dtype,momentum,scale", [
    (jnp.float32, 0.9, True), (jnp.float32, 0.99, False), (jnp.bfloat16, 0.99, True)])
def test_batchnorm_training_matches_flax(dtype, momentum, scale):
    """Output, gradients and running statistics (the biased fast variance,
    Flax's update rule) over three batches."""
    import flax.linen as fnn

    bn = fnn.BatchNorm(use_running_average=False, momentum=momentum, epsilon=1e-3,
                       use_scale=scale, dtype=dtype)
    rng = np.random.RandomState(0)
    xs = [rng.normal(1.5, 2.0, (4, 5, 6, 16)).astype(np.float32) for _ in range(3)]
    w = rng.normal(size=(4, 5, 6, 16)).astype(np.float32)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0], dtype))
    params = {"bias": rng.normal(0, 0.2, 16).astype(np.float32)}
    if scale:
        params["scale"] = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    stats = _host(variables["batch_stats"])
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    mine = BatchNorm(16, 1e-3, momentum=momentum, scale=scale)
    mine.load_state_dict({k.split(".", 1)[1]: v for k, v in from_flax_variables(
        {"params": {"bn": params}, "batch_stats": {"bn": stats}}).items()})
    assert isinstance(mine.weight, nn.Parameter) == scale
    mine.train()
    for x in xs:
        def loss(p, x):
            y, upd = bn.apply({"params": p, "batch_stats": stats}, x, mutable=["batch_stats"])
            return (y.astype(jnp.float32) * w).sum(), (y, upd)

        (_, (y_j, upd)), (g_p, g_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            params, jnp.asarray(x, dtype))
        stats = _host(upd["batch_stats"])
        xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2).requires_grad_()
        y = mine(xt)
        (y.float() * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()
        assert y.dtype == tdt
        tol = 1e-5 if tdt == torch.float32 else 2e-2
        np.testing.assert_allclose(y.detach().float().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(y_j, np.float32), atol=tol, rtol=tol)
        np.testing.assert_allclose(xt.grad.float().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(g_x, np.float32), atol=tol, rtol=tol)
        np.testing.assert_allclose(mine.bias.grad.numpy(), np.asarray(g_p["bias"]), rtol=1e-4,
                                   atol=1e-4)
        if scale:
            np.testing.assert_allclose(mine.weight.grad.numpy(), np.asarray(g_p["scale"]),
                                       rtol=1e-3, atol=1e-3)
            mine.weight.grad = None
        mine.bias.grad = None
        np.testing.assert_allclose(mine.running_mean.numpy(), stats["mean"], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(mine.running_var.numpy(), stats["var"], rtol=1e-6, atol=1e-6)


# ---- the Trainer against JAX's (TinyNet) ----

def test_float32_trainer_matches_jax_trainer():
    jt, tr = _pair()
    imgs, labels = _batch()
    j_metrics = [jt.step(imgs, labels) for _ in range(4)]
    metrics = [tr.step(imgs, labels) for _ in range(4)]
    np.testing.assert_allclose([m["loss"] for m in metrics], [m["loss"] for m in j_metrics],
                               rtol=1e-5)
    assert [m["accuracy"] for m in metrics] == [m["accuracy"] for m in j_metrics]
    assert metrics[-1]["loss"] < metrics[0]["loss"] and tr.last_step_time > 0
    assert_state_close(tr.state, jt.state, _pre_bn_conv_biases(tr.model), steps=4, lr=LR)
    assert tr.state["opt_state"]["count"] == 4
    assert all(p.dtype == torch.float32 for p in tr.params.values())


def test_state_from_jax_trainer_resumes_with_its_losses():
    """A JAX Trainer runs 2 steps; its state, converted, continues in the
    port with JAX's next 2 losses; then evaluate agrees on that state and
    mutates nothing."""
    jt, tr = _pair()
    imgs, labels = _batch(1)
    for _ in range(2):
        jt.step(imgs, labels)
    tr.state = image_train_state_from_flax(_host(jt.state), device="cpu")
    assert tr.state["step"] == 2 and tr.state["opt_state"]["count"] == 2
    e_imgs, e_labels = _batch(2)
    before = {k: {n: t.clone() for n, t in v.items()} for k, v in tr.state.items()
              if k in ("params", "batch_stats")}
    j_eval, got = jt.evaluate(e_imgs, e_labels), tr.evaluate(e_imgs, e_labels)
    assert abs(got["loss"] - j_eval["loss"]) <= 1e-5 * abs(j_eval["loss"])
    assert got["accuracy"] == j_eval["accuracy"]
    after = tr.state
    assert after["step"] == 2 and after["opt_state"]["count"] == 2
    for k, v in before.items():
        for n, t in v.items():
            assert torch.equal(after[k][n], t), (k, n)
    j_next = [jt.step(imgs, labels)["loss"] for _ in range(2)]
    np.testing.assert_allclose([tr.step(imgs, labels)["loss"] for _ in range(2)], j_next,
                               rtol=1e-5)


def test_grad_accum_matches_jax_grad_accum():
    jt, tr = _pair(grad_accum=2)
    imgs, labels = _batch(3)
    j_metrics = [jt.step(imgs, labels) for _ in range(3)]
    metrics = [tr.step(imgs, labels) for _ in range(3)]
    np.testing.assert_allclose([m["loss"] for m in metrics], [m["loss"] for m in j_metrics],
                               rtol=1e-5)
    np.testing.assert_allclose([m["accuracy"] for m in metrics],
                               [m["accuracy"] for m in j_metrics], rtol=1e-6)
    # the running statistics moved through both micro-batches, in order
    assert_state_close(tr.state, jt.state, _pre_bn_conv_biases(tr.model), steps=3, lr=LR)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_remat_matches_plain_step_and_moves_stats_once(grad_accum):
    v = _tiny_variables()
    imgs, labels = _batch(4)
    runs = {}
    for remat in (False, True):
        tr = train.Trainer("TinyNet", batch_size=BATCH, dtype=torch.float32, num_classes=CLASSES,
                           variables=v, learning_rate=LR, remat=remat, grad_accum=grad_accum,
                           device="cpu")
        losses = [tr.step(imgs, labels)["loss"] for _ in range(3)]
        runs[remat] = (losses, tr.state["batch_stats"])
    np.testing.assert_allclose(runs[True][0], runs[False][0], rtol=1e-5)
    for n, s in runs[False][1].items():
        torch.testing.assert_close(runs[True][1][n], s, rtol=1e-6, atol=1e-7)


def test_checkpoint_resume_and_export_into_the_engine(tmp_path):
    tr = train.Trainer("TinyNet", batch_size=BATCH, dtype=torch.float32, num_classes=CLASSES,
                       variables=_tiny_variables(), learning_rate=LR, device="cpu")
    imgs, labels = _batch(5)
    for _ in range(2):
        tr.step(imgs, labels)
    path = tr.save_checkpoint(str(tmp_path))
    assert path.endswith("step_2.pt")
    ahead = [tr.step(imgs, labels)["loss"] for _ in range(2)]
    assert tr.restore_checkpoint(str(tmp_path)) == 2
    assert [tr.step(imgs, labels)["loss"] for _ in range(2)] == ahead

    # the export: a float32 CPU state_dict that the port's engine serves
    # with the trainer's own inference-mode probabilities
    sd = tr.export_variables()
    assert all(t.dtype == torch.float32 and t.device.type == "cpu" for t in sd.values())
    eng = InferenceEngine(dtype=torch.float32, device="cpu")
    eng.load_model("TinyNet", variables=sd, batch_size=BATCH, warmup=False)
    probs = eng.infer_arrays("TinyNet", imgs)
    tr.model.eval()
    with torch.no_grad():
        want = tr.model(torch.from_numpy(imgs).float() / 255.0).numpy()
    tr.model.train()
    np.testing.assert_allclose(probs, want, atol=1e-6)
    assert float((probs.argmax(-1) == labels).mean()) == tr.evaluate(imgs, labels)["accuracy"]


# ---- the step, the schedule and the metrics, function by function ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_narrow_resnet_step_matches_jax_make_train_step(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jm = JaxResNet(depths=(1, 1, 1, 1), num_classes=CLASSES, dtype=jdt)
    v = _host(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32), train=False))
    lr = 1e-3  # the loss stays near 2-3: 8 images do not get memorized in 3 steps
    opt = optax.sgd(lr)
    state = {"params": v["params"], "batch_stats": v["batch_stats"],
             "opt_state": opt.init(v["params"]), "step": jnp.zeros((), jnp.int32)}
    j_step = jax.jit(jax_train.make_train_step(jm, "caffe", opt, jdt))
    model = ResNet(depths=(1, 1, 1, 1), num_classes=CLASSES, dtype=tdt, param_dtype=torch.float32)
    model.load_state_dict(from_flax_variables(v))
    model = model.to(memory_format=torch.channels_last)
    step = train.make_train_step(model, "caffe", torch.optim.SGD(model.parameters(), lr=lr), tdt)
    imgs, labels = _batch(6)
    steps = 3 if dtype == "float32" else 1
    j_losses, losses = [], []
    for _ in range(steps):
        state, m = j_step(state, jnp.asarray(imgs), jnp.asarray(labels))
        j_losses.append(float(m["loss"]))
        losses.append(float(step(torch.from_numpy(imgs), torch.from_numpy(labels))["loss"]))
    if dtype == "float32":
        np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
        got = {"params": {n: p.detach() for n, p in model.named_parameters()},
               "batch_stats": {n: b for n, b in model.named_buffers() if "running" in n},
               "step": steps}
        assert_state_close(got, state, set(), steps=steps, lr=lr)
    else:
        assert abs(losses[0] - j_losses[0]) <= 1e-2 * abs(j_losses[0])
        want = params_from_flax(_host(state["batch_stats"]), "batch_stats")
        for n, b in model.named_buffers():
            if "running" in n:
                d = float((b - want[n]).abs().max())
                assert d <= 1e-2 * max(1.0, float(want[n].abs().max())), (n, d)
        assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                   for p in model.parameters())


@pytest.mark.parametrize("peak,warmup,total,end", [
    (1e-3, 5, 20, 0.0), (3e-4, 0, 10, 1e-5), (2e-3, 8, 4, 1e-4)])
def test_warmup_cosine_matches_optax(peak, warmup, total, end):
    sched = train.warmup_cosine(peak, warmup, total, end)
    want = jax_train.warmup_cosine(peak, warmup, total, end)
    steps = range(max(total, warmup + 1) + 5)
    # optax evaluates the cosine in float32
    np.testing.assert_allclose([sched(s) for s in steps], [float(want(s)) for s in steps],
                               rtol=5e-6, atol=1e-12)
    assert sched(0) == 0.0 or warmup == 0


def test_schedule_sets_the_rate_before_each_update():
    """A Trainer with warmup_cosine against JAX's with the same schedule
    (the first update's rate is 0: the weights do not move, the moments
    do)."""
    v = _tiny_variables()
    imgs, labels = _batch(7)
    jt = jax_train.Trainer("TinyNet", _mesh(), batch_size=BATCH, dtype=jnp.float32,
                           num_classes=CLASSES, variables=v,
                           learning_rate=jax_train.warmup_cosine(LR, 2, 6))
    tr = train.Trainer("TinyNet", batch_size=BATCH, dtype=torch.float32, num_classes=CLASSES,
                       variables=v, learning_rate=train.warmup_cosine(LR, 2, 6), device="cpu")
    start = {n: p.clone() for n, p in tr.params.items()}
    losses = [tr.step(imgs, labels)["loss"] for _ in range(4)]
    np.testing.assert_allclose(losses, [jt.step(imgs, labels)["loss"] for _ in range(4)],
                               rtol=1e-5)
    assert losses[1] == losses[0]  # the first update's rate is 0
    assert tr.optimizer.param_groups[0]["lr"] == pytest.approx(train.warmup_cosine(LR, 2, 6)(3))
    assert any(not torch.equal(start[n], p) for n, p in tr.params.items())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_classification_metrics_match_jax(dtype):
    rng = np.random.RandomState(8)
    logits = rng.normal(size=(16, CLASSES)).astype(np.float32)
    logits[3, 0] = -40.0  # a probability near 0: the 1e-9 floor decides its log
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), -1))
    labels = rng.randint(0, CLASSES, 16).astype(np.int32)
    labels[3] = 0
    j_nll, j_acc = jax_train.classification_metrics(
        jnp.asarray(probs, getattr(jnp, dtype)), jnp.asarray(labels))
    nll, acc = train.classification_metrics(torch.from_numpy(probs).to(getattr(torch, dtype)),
                                            torch.from_numpy(labels).long())
    assert nll.dtype == acc.dtype == torch.float32
    np.testing.assert_allclose(float(nll), float(j_nll), rtol=1e-6)
    assert float(acc) == float(j_acc)


# ---- the parameter set, and what raises ----

@pytest.mark.parametrize("name", ["ResNet50", "InceptionV3"])
def test_trainable_parameters_map_onto_flax_params(name):
    """One to one, names and shapes, with Flax's `params` leaves: no BN
    scale for InceptionV3 (Keras builds it without one), float32 masters."""
    jax_model, size = (JaxResNet50(num_classes=CLASSES), 32) if name == "ResNet50" else (
        JaxInceptionV3(num_classes=CLASSES), 75)
    shapes = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3), jnp.float32), train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    want = {n: tuple(t.shape) for n, t in params_from_flax(zeros).items()}
    model = get_model(name).build(dtype=torch.bfloat16, num_classes=CLASSES,
                                  param_dtype=torch.float32)
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == want
    assert all(p.dtype == torch.float32 for p in model.parameters())
    if name == "InceptionV3":
        assert not any("batch_normalization" in n and n.endswith(".weight") for n in got)
        assert "batch_normalization_0.weight" in model.state_dict()  # a buffer of ones


def test_arguments_the_jax_trainer_refuses_raise(monkeypatch):
    v = _tiny_variables()
    with pytest.raises(ValueError):
        jax_train.Trainer("TinyNet", _mesh(), batch_size=BATCH, variables=v,
                          num_classes=CLASSES, grad_accum=3)
    with pytest.raises(ValueError, match="grad_accum 3 must divide batch_size 8"):
        train.Trainer("TinyNet", batch_size=BATCH, variables=v, num_classes=CLASSES,
                      grad_accum=3, device="cpu")
    with pytest.raises(TypeError, match="batch_size"):
        train.Trainer("TinyNet", device="cpu")
    with pytest.raises(NotImplementedError, match="A5"):
        train.Trainer("TinyNet", {"dp": 2}, batch_size=BATCH, device="cpu")
    with pytest.raises(NotImplementedError, match="A5"):
        train.Trainer("TinyNet", make_mesh(MeshSpec(dp=2), devices=jax.devices()[:2]),
                      batch_size=BATCH, device="cpu")
    tr = train.Trainer("TinyNet", _mesh(), batch_size=BATCH, variables=v, num_classes=CLASSES,
                       device="cpu")
    with pytest.raises(TypeError, match="uint8"):
        tr.step(np.zeros((BATCH, 32, 32, 3), np.float32), np.zeros(BATCH, np.int32))
    with pytest.raises(TypeError, match="Adam"):
        train.Trainer("TinyNet", batch_size=BATCH, num_classes=CLASSES, device="cpu",
                      optimizer=lambda ps: torch.optim.SGD(ps, lr=0.1))
    # cuda by default, and it raises without a card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.Trainer("TinyNet", batch_size=BATCH, num_classes=CLASSES)
