"""The port's dp and tp forms (`dml_tpu_torch.parallel.mesh`, `sharding`,
`inference`, `train`, `multihost`, and `ops.preprocess.
normalize_sharded` over a mesh) against the JAX package's on the CPU.

The port runs one process per rank: one module-scoped session of four
gloo ranks (real processes, rendezvous through a `file://` under the
test's temporary directory) runs every check below and writes its
results there; the test functions read them. The ranks import torch and
the port only, never jax or `dml_tpu`; their TinyNet is a jax-free copy
of `tests/test_torch_train.py`'s. The JAX side runs in this process on
the first four of the tests' 8 virtual CPU devices, with the same seeded
numpy inputs and the same weights (`init_variables`, handed to the ranks
as numpy and converted there by `from_flax_variables`).

Tolerances:
- mesh coordinates, `partition_params` pieces (against the JAX array's
  shard on the device at the same mesh coordinates), `normalize_sharded`
  rows and `ShardedInference(param_gather=True)` against the port's one
  device: bitwise;
- both `ShardedInference` forms against JAX's on the same mesh: rtol
  2e-4, atol 2e-5 (`tests/test_parallel.py:48-65`);
- the dp 2 x tp 2 Trainer against JAX's on the same mesh: losses within
  1e-5 relative (the port's one-device bar; measured 7.1e-7 over 4
  steps, and 1.7e-6 with grad_accum=2 over 3), accuracies equal, the
  gathered params and running statistics within `test_torch_train.
  assert_state_close`'s bounds (measured 6.9e-7 on the params outside
  the conv bias before BatchNorm), and the AdamW moments within 1e-4 of
  each moment's largest magnitude (measured 5.0e-6), that bias's (noise
  around 0, see test_torch_train) within 1e-6 and 1e-12 (measured 3.7e-8
  and 1.1e-16); `remat=True` within 1e-5 of the plain step
  (`tests/test_parallel.py:140-152`; measured equal);
- both `ShardedInference` forms measured 7e-10 from JAX, and bitwise
  equal to the port's one device (only `param_gather=True` is held to
  that);
- checkpoints across meshes: bitwise (`tests/test_checkpoint.py:125-170`).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tinynet import ensure_tinynet
from dml_tpu.config import MeshSpec as JaxMeshSpec
from dml_tpu.models.params_io import init_variables as jax_init_variables
from dml_tpu.models.resnet import ResNet50 as JaxResNet50
from dml_tpu.ops.preprocess import normalize_sharded as jax_normalize_sharded
from dml_tpu.parallel import train as jax_train
from dml_tpu.parallel.inference import ShardedInference as JaxShardedInference
from dml_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dml_tpu.parallel.sharding import partition_params as jax_partition_params
from dml_tpu_torch.models import registry as port_registry
from dml_tpu_torch.models.params_io import image_train_state_from_flax
from dml_tpu_torch.parallel.sharding import P, partition_params
from test_torch_train import assert_state_close

WORLD, CLASSES, LR, BATCH = 4, 10, 1e-2, 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r'''
import os, sys
import numpy as np
import torch

torch.set_num_threads(1)
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

out_dir, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
dist.init_process_group("gloo", init_method="file://" + os.path.join(out_dir, "rendezvous"),
                        world_size=world, rank=rank)

from dml_tpu_torch.config import MeshSpec
from dml_tpu_torch.inference import InferenceEngine
from dml_tpu_torch.models.layers import BatchNorm, Conv2d
from dml_tpu_torch.models.params_io import from_flax_variables
from dml_tpu_torch.models.registry import CostDefaults, ModelSpec, register
from dml_tpu_torch.ops import preprocess as ops
from dml_tpu_torch.parallel import multihost, train
from dml_tpu_torch.parallel.inference import ShardedInference
from dml_tpu_torch.parallel.mesh import all_gather, make_mesh, resolve_mesh
from dml_tpu_torch.parallel.sharding import gather, partition_params, shard


class TinyNet(nn.Module):
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


register(ModelSpec(name="TinyNet", builder=TinyNet, input_size=(32, 32), preprocess="unit",
                   cost=CostDefaults(load_time=0.1, first_query=0.1, per_query=0.01,
                                     default_batch_size=4)))
inp = np.load(os.path.join(out_dir, "inputs.npz"))
flax = {k[4:]: inp[k] for k in inp.files if k.startswith("var/")}
iflax = {k[5:]: inp[k] for k in inp.files if k.startswith("ivar/")}  # 1000 classes
f32 = torch.float32
R = {}


def raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def copy(tree):
    if isinstance(tree, dict):
        return {k: copy(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def rows(a, mesh):
    k = len(a) // mesh.shape["dp"]
    return a[mesh.coords["dp"] * k:(mesh.coords["dp"] + 1) * k]


def trainer(mesh, **kw):
    kw = {"num_classes": 10, "variables": flax, "learning_rate": 1e-2, **kw}
    return train.Trainer("TinyNet", mesh, batch_size=8, dtype=f32, device="cpu", **kw)


# ---- mesh ----
m22 = make_mesh(MeshSpec(dp=-1, tp=2))
R["mesh_shape"], R["coords"] = dict(m22.shape), dict(m22.coords)
R["bad_shape"] = raises(lambda: make_mesh(MeshSpec(dp=3, tp=3)))
m01 = make_mesh(MeshSpec(dp=2), ranks=[0, 1])
R["m01_rank"], R["m01_coords"] = m01.rank, m01.coords
R["no_group"] = raises(lambda: resolve_mesh({"dp": 2, "tp": 2}))
R["no_group_trainer"] = raises(lambda: trainer({"dp": 2}))

# ---- partition_params ----
sd = from_flax_variables(flax)
specs = partition_params(sd, m22)
R["specs"] = {n: tuple(s) for n, s in specs.items()}
R["pieces"] = {n: shard(t, specs[n], m22) for n, t in sd.items()}
R["gathered_equal"] = all(torch.equal(gather(R["pieces"][n], specs[n], m22), t)
                          for n, t in sd.items())

# ---- normalize_sharded: K1's plain version on this rank's rows ----
R["norm"] = {f"{mode}/{dt}": ops.normalize_sharded(
    torch.from_numpy(rows(inp["norm_x"], m22)), mode, getattr(torch, dt), m22).float()
    for mode in ("caffe", "tf", "unit") for dt in ("float32", "bfloat16")}

# ---- ShardedInference ----
for pg in (True, False):
    sh = ShardedInference("TinyNet", m22, batch_size=8, variables=iflax, dtype=f32,
                          param_gather=pg, device="cpu")
    R[f"sharded_{pg}"] = sh(inp["inf_imgs"])
if rank == 0:
    eng = InferenceEngine(dtype=f32, device="cpu")
    eng.load_model("TinyNet", variables=iflax, batch_size=8, warmup=False)
    R["one_device"] = eng.infer_arrays("TinyNet", inp["inf_imgs"])
m4 = make_mesh(MeshSpec(dp=4))
R["ragged"] = ShardedInference("TinyNet", m4, batch_size=8, variables=iflax, dtype=f32,
                               device="cpu")(inp["ragged_imgs"])

# ---- Trainer at dp 2 x tp 2 ----
ti, tl = inp["train_imgs"], inp["train_labels"]
tr = trainer(m22)
ms = [tr.step(ti, tl) for _ in range(4)]
names = [n for n, _ in tr.model.named_parameters()]
pieces = tr.optimizer.param_groups[0]["params"]
R["train"] = {"losses": [m["loss"] for m in ms], "accs": [m["accuracy"] for m in ms],
              "state": copy(tr.state),
              "local": {n: p.numel() for n, p in zip(names, pieces)},
              "moments_local": {n: tr.optimizer.state[p]["exp_avg"].numel()
                                for n, p in zip(names, pieces)}}
tg = trainer(m22)
gb = [multihost.global_batch(rows(a, m22), m22, device="cpu") for a in (ti, tl)]
R["global_batch_loss"] = tg.step(*gb)["loss"]
ga = trainer(m22, grad_accum=2)
ga_ms = [ga.step(inp["ga_imgs"], inp["ga_labels"]) for _ in range(3)]
R["ga"] = {"losses": [m["loss"] for m in ga_ms], "accs": [m["accuracy"] for m in ga_ms],
           "state": copy(ga.state)}
rm = trainer(m22, remat=True)
R["remat_losses"] = [rm.step(ti, tl)["loss"] for _ in range(3)]
ts = trainer(m22, learning_rate=train.warmup_cosine(1e-2, 2, 10))
si, sl = inp["sched_imgs"], inp["sched_labels"]
before = ts.evaluate(si, sl)
sched_losses = [ts.step(si, sl)["loss"] for _ in range(6)]
after = ts.evaluate(si, sl)
s0 = copy(ts.state)
ts.evaluate(si, sl)
R["sched"] = {"before": before, "after": after, "losses": sched_losses,
              "evaluate_mutates_nothing": equal(ts.state, s0)}
exported = tr.export_variables()
R["export"] = exported
if rank == 0:
    eng = InferenceEngine(dtype=f32, device="cpu")
    eng.load_model("TinyNet", variables=exported, batch_size=8, warmup=False)
    R["export_probs"] = eng.infer_arrays("TinyNet", ti)

# ---- checkpoints across meshes ----
ck4 = os.path.join(out_dir, "ck_dp4")
t4 = train.Trainer("TinyNet", m4, batch_size=8, dtype=f32, device="cpu")
ci, cl = inp["ck_imgs"], inp["ck_labels"]
t4.step(ci, cl)
t4.step(ci, cl)
saved = copy(t4.state)
t4.save_checkpoint(ck4)
for dp_to, bs_to in ((2, 8), (3, 6)):
    mt = make_mesh(MeshSpec(dp=dp_to), ranks=range(dp_to))
    if mt.rank is None:
        continue
    t2 = train.Trainer("TinyNet", mt, batch_size=bs_to, dtype=f32, seed=9, device="cpu")
    step = t2.restore_checkpoint(ck4)
    restored_equal = equal(t2.state, saved)
    m = t2.step(ci[:bs_to], cl[:bs_to])
    R[f"restore_dp{dp_to}"] = {"step": step, "equal": restored_equal, "loss": m["loss"],
                               "step_after": t2.state["step"]}
ck22 = os.path.join(out_dir, "ck_dp2tp2")
tr.save_checkpoint(ck22)
if rank == 0:
    one = train.Trainer("TinyNet", batch_size=8, dtype=f32, num_classes=10, seed=3, device="cpu")
    R["ck22_step"] = one.restore_checkpoint(ck22)
    R["ck22_equal"] = equal(one.state, R["train"]["state"])

# ---- multihost.global_batch feeding a dp-sharded step ----
gbd = multihost.global_batch(rows(inp["mh_data"], m22), m22, device="cpu")
R["global_batch"] = {"shape": tuple(gbd.shape), "local": gbd.local,
                     "step": all_gather((gbd.local * 2).sum(1), m22, "dp", 0)}

torch.save(R, os.path.join(out_dir, f"rank{rank}.pt"))
dist.barrier()
dist.destroy_process_group()
print("RANK_OK", rank)
'''


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _batch(seed, n=BATCH, classes=CLASSES):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, 32, 32, 3)).astype(np.uint8),
            rng.randint(0, classes, n).astype(np.int32))


class Session:
    """The four ranks, started at once; `results()` waits for them."""

    def __init__(self, out_dir, inputs):
        self.dir, self.inputs = out_dir, inputs
        flat = {}

        def walk(tree, prefix):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}/")
                else:
                    flat[prefix + k] = np.asarray(v)

        walk(inputs["variables"], "var/")
        walk(inputs["inf_variables"], "ivar/")
        np.savez(out_dir / "inputs.npz", **flat,
                 **{k: v for k, v in inputs.items() if not k.endswith("variables")})
        (out_dir / "child.py").write_text(CHILD)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join([REPO] + env.get("PYTHONPATH", "").split(os.pathsep))
        self.procs = [subprocess.Popen(
            [sys.executable, str(out_dir / "child.py"), str(out_dir), str(r), str(WORLD)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
            for r in range(WORLD)]
        self._results = None

    def results(self):
        if self._results is None:
            outs = []
            try:
                for p in self.procs:
                    outs.append(p.communicate(timeout=180)[0])
            except subprocess.TimeoutExpired:
                for p in self.procs:
                    p.kill()
                pytest.fail("the gloo ranks hung:\n" + "\n---\n".join(outs))
            for r, (p, out) in enumerate(zip(self.procs, outs)):
                assert p.returncode == 0 and f"RANK_OK {r}" in out, f"rank {r} failed:\n{out}"
            self._results = [torch.load(self.dir / f"rank{r}.pt", weights_only=False)
                             for r in range(WORLD)]
        return self._results


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    spec = ensure_tinynet()
    variables = _host(jax_init_variables(spec, seed=0, dtype=jnp.float32, num_classes=CLASSES))
    rng = np.random.RandomState(0)
    inputs = {"variables": variables,
              "inf_variables": _host(jax_init_variables(spec, seed=0, dtype=jnp.float32)),
              "norm_x": rng.randint(0, 256, (8, 9, 7, 3)).astype(np.uint8),
              "inf_imgs": rng.randint(0, 255, (8, 32, 32, 3)).astype(np.uint8),
              "ragged_imgs": rng.randint(0, 255, (13, 32, 32, 3)).astype(np.uint8),
              "mh_data": rng.randn(8, 16).astype(np.float32)}
    for key, seed, classes in (("train", 1, CLASSES), ("ga", 3, CLASSES),
                               ("sched", 5, CLASSES), ("ck", 7, 1000)):
        inputs[f"{key}_imgs"], inputs[f"{key}_labels"] = _batch(seed, classes=classes)
    s = Session(tmp_path_factory.mktemp("ranks"), inputs)
    yield s
    for p in s.procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh(JaxMeshSpec(dp=2, tp=2), devices=jax.devices()[:WORLD])


def _jax_coords(mesh, device_index):
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    return [int(i) for i in np.argwhere(ids == jax.devices()[device_index].id)[0]]


_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
           "var": "running_var"}


def _port_name(path):
    """A Flax leaf's path (collection, layers..., leaf) -> its state_dict key."""
    keys = [p.key for p in path]
    return f"{'.'.join(keys[1:-1])}.{_LEAVES[keys[-1]]}"


def _torch_layout(arr):
    """A Flax leaf (or a shard of one) in the port's layout."""
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    return arr.T if arr.ndim == 2 else arr


# ---- mesh ----

def test_mesh_coordinates_match_jax_device_order(session, jax_mesh):
    res = session.results()
    for r, R in enumerate(res):
        assert R["mesh_shape"] == {"dp": 2, "tp": 2, "sp": 1, "pp": 1, "ep": 1}
        assert [R["coords"][a] for a in ("dp", "tp", "sp", "pp", "ep")] == _jax_coords(jax_mesh, r)
    with pytest.raises(ValueError):
        jax_make_mesh(JaxMeshSpec(dp=3, tp=3), devices=jax.devices()[:WORLD])
    assert all("!= 4 devices" in R["bad_shape"] for R in res)


def test_mesh_over_some_ranks_and_mesh_without_group(session):
    res = session.results()
    assert [R["m01_rank"] for R in res] == [0, 1, None, None]
    assert [R["m01_coords"]["dp"] for R in res[:2]] == [0, 1]
    for R in res:
        assert "has no process group" in R["no_group"]
        assert "has no process group" in R["no_group_trainer"]


# ---- partition_params ----

def test_partition_pieces_equal_jax_device_shards(session, jax_mesh):
    res = session.results()
    variables = session.inputs["variables"]
    shardings = jax_partition_params(variables, jax_mesh)
    placed = jax.device_put(variables, shardings)
    flat_sh = dict(jax.tree_util.tree_flatten_with_path(shardings)[0])
    for path, arr in jax.tree_util.tree_flatten_with_path(placed)[0]:
        name = _port_name(path)
        sharded = "tp" in tuple(flat_sh[path].spec)
        for shard in arr.addressable_shards:
            coords = _jax_coords(jax_mesh, jax.devices().index(shard.device))
            r = next(r for r, R in enumerate(res)
                     if [R["coords"]["dp"], R["coords"]["tp"]] == coords[:2])
            assert (res[r]["specs"][name] == ("tp",) + (None,) * (arr.ndim - 1)) == sharded, name
            np.testing.assert_array_equal(res[r]["pieces"][name].numpy(),
                                          _torch_layout(np.asarray(shard.data)), err_msg=name)
    assert all(R["gathered_equal"] for R in res)  # the pieces gather back to the leaves


def test_partition_rule_on_resnet50_tree_matches_jax():
    """Every leaf of ResNet50's params and batch_stats, by shape alone: a
    leaf is sharded in the port exactly when JAX's spec names tp, on the
    dim that holds the Flax leaf's last axis (dim 0 in the port)."""
    mesh = jax_make_mesh(JaxMeshSpec(dp=2, tp=2), devices=jax.devices()[:WORLD])
    shapes = jax.eval_shape(lambda: JaxResNet50(num_classes=1000).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32), train=False))
    jax_specs = jax_partition_params(shapes, mesh)
    with torch.device("meta"):
        port = port_registry.get_model("ResNet50").build(dtype=torch.float32).state_dict()
    specs = partition_params(port, {"dp": 2, "tp": 2})
    seen = 0
    for path, sh in jax.tree_util.tree_flatten_with_path(jax_specs)[0]:
        name = _port_name(path)
        want_sharded = tuple(sh.spec)[-1:] == ("tp",)
        assert (specs[name] == P("tp", *([None] * (len(port[name].shape) - 1)))) == want_sharded
        assert (specs[name] == P()) == (not want_sharded), name
        seen += 1
    assert seen == len(port) and seen > 300


def test_partition_rule_dense_and_odd_example():
    """tests/test_parallel.py:36-45 in the port's layout ([out, in])."""
    tree = {"dense": {"weight": torch.zeros(64, 16), "bias": torch.zeros(64)},
            "odd": {"weight": torch.zeros(7, 16)}}
    sh = partition_params(tree, {"dp": 4, "tp": 2})
    assert sh["dense"]["weight"] == P("tp", None)
    assert sh["dense"]["bias"] == P("tp")
    assert sh["odd"]["weight"] == P()
    assert partition_params({"blocks.0.moe.w_up": torch.zeros(8, 4, 4)},
                            {"tp": 2})["blocks.0.moe.w_up"] == P()


# ---- normalize_sharded ----

@pytest.mark.parametrize("mode", ["caffe", "tf", "unit"])
def test_normalize_sharded_rows_equal_jax(session, jax_mesh, mode):
    x = session.inputs["norm_x"]
    res = session.results()
    for dt in ("float32", "bfloat16"):
        want = np.asarray(jax_normalize_sharded(jnp.asarray(x), mode, getattr(jnp, dt),
                                                jax_mesh)).astype(np.float32)
        for R in res:
            d = R["coords"]["dp"]
            np.testing.assert_array_equal(R["norm"][f"{mode}/{dt}"].numpy(), want[d * 4:(d + 1) * 4])


# ---- ShardedInference ----

def test_sharded_inference_matches_one_device_and_jax(session, jax_mesh):
    imgs = session.inputs["inf_imgs"]
    variables = session.inputs["inf_variables"]
    jax_out = {pg: JaxShardedInference("TinyNet", jax_mesh, batch_size=8, variables=variables,
                                       dtype=jnp.float32, param_gather=pg)(imgs)
               for pg in (True, False)}
    res = session.results()
    one = res[0]["one_device"]
    for R in res:
        np.testing.assert_array_equal(R["sharded_True"], one)  # bitwise, every rank
        for pg in (True, False):
            got = R[f"sharded_{pg}"]
            assert got.shape == (8, 1000) and got.dtype == np.float32
            np.testing.assert_allclose(got, jax_out[pg], rtol=2e-4, atol=2e-5)
            np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-3)


def test_sharded_inference_pads_ragged_batches(session):
    for R in session.results():
        assert R["ragged"].shape == (13, 1000)
        assert np.isfinite(R["ragged"]).all()


# ---- Trainer at dp 2 x tp 2 ----

def _jax_trainer(mesh, **kw):
    return jax_train.Trainer("TinyNet", mesh, batch_size=BATCH, dtype=jnp.float32,
                             num_classes=CLASSES, learning_rate=LR, **kw)


def _assert_moments_close(state, jax_state, noisy):
    """The AdamW moments (and count) against JAX's, converted."""
    want = image_train_state_from_flax(_host(jax_state), device="cpu")["opt_state"]
    assert state["opt_state"]["count"] == want["count"]
    for key, floor in (("exp_avg", 1e-6), ("exp_avg_sq", 1e-12)):
        for n, t in state["opt_state"][key].items():
            d = float((t - want[key][n]).abs().max())
            assert d <= (floor if n in noisy else 1e-4 * float(want[key][n].abs().max())), (
                key, n, d)


def test_trainer_matches_jax_trainer_on_the_same_mesh(session, jax_mesh):
    imgs, labels = session.inputs["train_imgs"], session.inputs["train_labels"]
    jt = _jax_trainer(jax_mesh, variables=session.inputs["variables"])
    j_metrics = [jt.step(imgs, labels) for _ in range(4)]
    res = session.results()
    for R in res:
        got = R["train"]
        np.testing.assert_allclose(got["losses"], [m["loss"] for m in j_metrics], rtol=1e-5)
        assert got["accs"] == [m["accuracy"] for m in j_metrics]
        assert_state_close(got["state"], jt.state, {"c1.bias"}, steps=4, lr=LR)
        _assert_moments_close(got["state"], jt.state, {"c1.bias"})
        assert got["state"]["opt_state"]["count"] == 4 and got["state"]["step"] == 4
        assert all(float(s.abs().sum()) > 0 for s in got["state"]["batch_stats"].values())
        assert got["losses"][-1] < got["losses"][0]
    # every rank holds 1/tp of each sharded leaf and of its moments
    full = {n: p.numel() for n, p in res[0]["train"]["state"]["params"].items()}
    for R in res:
        for n, numel in R["train"]["local"].items():
            assert numel * (2 if "tp" in R["specs"][n] else 1) == full[n], n
            assert R["train"]["moments_local"][n] == numel
        assert sum(R["train"]["local"].values()) < sum(full.values())
    # a GlobalBatch of each rank's rows is the same step
    assert all(R["global_batch_loss"] == R["train"]["losses"][0] for R in res)


def test_trainer_grad_accum_matches_jax_grad_accum(session, jax_mesh):
    imgs, labels = session.inputs["ga_imgs"], session.inputs["ga_labels"]
    jt = _jax_trainer(jax_mesh, variables=session.inputs["variables"], grad_accum=2)
    j_metrics = [jt.step(imgs, labels) for _ in range(3)]
    for R in session.results():
        got = R["ga"]
        np.testing.assert_allclose(got["losses"], [m["loss"] for m in j_metrics], rtol=1e-5)
        np.testing.assert_allclose(got["accs"], [m["accuracy"] for m in j_metrics], rtol=1e-6)
        assert_state_close(got["state"], jt.state, {"c1.bias"}, steps=3, lr=LR)
        _assert_moments_close(got["state"], jt.state, {"c1.bias"})


def test_trainer_remat_schedule_evaluate_and_export(session):
    for R in session.results():
        np.testing.assert_allclose(R["remat_losses"], R["train"]["losses"][:3], rtol=1e-5)
        s = R["sched"]
        assert np.isfinite(s["losses"]).all() and s["losses"][1] == s["losses"][0]
        assert s["after"]["loss"] < s["before"]["loss"]
        assert s["evaluate_mutates_nothing"]
        # the export: the full float32 state on every rank
        params = R["train"]["state"]["params"]
        assert all(torch.equal(R["export"][n], t) for n, t in params.items())
        assert all(t.dtype == torch.float32 and t.device.type == "cpu"
                   for t in R["export"].values())
    probs = session.results()[0]["export_probs"]
    assert probs.shape == (BATCH, CLASSES) and np.isfinite(probs).all()


# ---- checkpoints across meshes ----

@pytest.mark.parametrize("dp_to", [2, 3])
def test_checkpoint_restores_bitwise_onto_a_smaller_mesh(session, dp_to):
    res = session.results()
    for r, R in enumerate(res):
        key = f"restore_dp{dp_to}"
        if r >= dp_to:
            assert key not in R
            continue
        got = R[key]
        assert got["step"] == 2 and got["equal"]
        assert np.isfinite(got["loss"]) and got["step_after"] == 3


def test_dp2_tp2_checkpoint_restores_bitwise_on_one_device(session):
    R = session.results()[0]
    assert R["ck22_step"] == 4 and R["ck22_equal"]


# ---- multihost.global_batch ----

def test_global_batch_gives_each_rank_its_rows(session):
    data = session.inputs["mh_data"]
    for R in session.results():
        d = R["coords"]["dp"]
        assert R["global_batch"]["shape"] == (8, 16)
        np.testing.assert_array_equal(R["global_batch"]["local"].numpy(), data[d * 4:(d + 1) * 4])
        np.testing.assert_allclose(R["global_batch"]["step"].numpy(), (data * 2).sum(1),
                                   rtol=1e-6)
