"""The port's continuous-batching LM server (dml_tpu_torch/inference/
lm_server.py) against the JAX package's, on the CPU.

Each case is the counterpart of one in tests/test_lm_server.py: the same
JAX-initialised weights (the JAX tests' config: vocab 61, d_model 32, 4
heads, 2 KV heads, 2 layers, float32), carried across by
`lm_params_from_flax`, and the same numpy-seeded prompts go through the
JAX server and the port's. Greedy tokens must equal the JAX server's and
JAX `generate`'s exactly. Two cases are the port's own: the sampled
stream contract (the port's sampler is not JAX's threefry stream, so
sampled tokens are held to the contract, not to JAX's bits) and a freed
slot stepping far past max_len with no out-of-range write.
"""

import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_tpu.inference.generate import LMConfig as JaxConfig
from dml_tpu.inference.generate import generate as jax_generate
from dml_tpu.inference.lm_server import LMServer as JaxServer
from dml_tpu.models.transformer import TransformerLM as JaxLM
from dml_tpu_torch.inference import generate as tg
from dml_tpu_torch.inference.lm_server import LMDriver, LMServer, _bucket
from dml_tpu_torch.models.lm_params import lm_params_from_flax
from dml_tpu_torch.observability import METRICS

SHAPE = dict(vocab_size=61, d_model=32, n_heads=4, n_layers=2, d_ff=64, n_kv_heads=2)
JCFG = JaxConfig(dtype=jnp.float32, **SHAPE)
CFG = tg.LMConfig(dtype=torch.float32, **SHAPE)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def both():
    """(JAX params, the port's params) on the same JAX-initialised weights."""
    model = JaxLM(dtype=jnp.float32, **SHAPE)
    jp = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jp, lm_params_from_flax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _isolated(jp, prompt, n):
    return np.asarray(jax_generate(jp, JCFG, jnp.asarray(np.asarray(prompt, np.int32)[None]), n))[0]


def _serve(server_cls, params, cfg, reqs, **kw):
    srv = server_cls(params, cfg, **kw)
    rids = [srv.submit(p, n) for p, n in reqs]
    out = srv.run()
    return [out[r] for r in rids]


def _check_three_ways(both, reqs, **kw):
    """Port tokens == the JAX server's == JAX generate's, request by request."""
    jp, tp = both
    mine = _serve(LMServer, tp, CFG, reqs, **kw)
    theirs = _serve(JaxServer, jp, JCFG, reqs, **kw)
    for i, (m, t, (p, n)) in enumerate(zip(mine, theirs, reqs)):
        np.testing.assert_array_equal(m, t, err_msg=f"req {i}: port vs JAX server")
        np.testing.assert_array_equal(m, _isolated(jp, p, n), err_msg=f"req {i}: port vs generate")


def test_bucket():
    assert _bucket(1) == 16 and _bucket(16) == 16
    assert _bucket(17) == 32 and _bucket(100) == 128
    assert _bucket(3, lo=1) == 4


@pytest.mark.parametrize("tp,n,seed", [(16, 10, 0), (11, 9, 1)], ids=["exact-bucket", "bucketed"])
def test_single_request_matches_jax(both, tp, n, seed):
    prompt = np.random.RandomState(seed).randint(0, CFG.vocab_size, tp)
    _check_three_ways(both, [(prompt, n)], max_slots=2, max_len=64, chunk=4)


def test_mixed_requests_batch_without_interference(both):
    rng = np.random.RandomState(2)
    reqs = [(rng.randint(0, CFG.vocab_size, 7), 12), (rng.randint(0, CFG.vocab_size, 16), 5),
            (rng.randint(0, CFG.vocab_size, 23), 9)]
    _check_three_ways(both, reqs, max_slots=3, max_len=64, chunk=4)


def test_slot_reuse_and_queueing(both):
    """More requests than slots: freed slots are reused and the stale
    rows of the previous occupant stay invisible."""
    rng = np.random.RandomState(3)
    reqs = [(rng.randint(0, CFG.vocab_size, 5 + 3 * i), 4 + 2 * i) for i in range(5)]
    _check_three_ways(both, reqs, max_slots=2, max_len=64, chunk=3)


def test_mid_flight_join(both):
    jp, tp = both
    rng = np.random.RandomState(4)
    p1 = rng.randint(0, CFG.vocab_size, 9)
    p2 = rng.randint(0, CFG.vocab_size, 6)
    outs = []
    for cls, params, cfg in ((LMServer, tp, CFG), (JaxServer, jp, JCFG)):
        srv = cls(params, cfg, max_slots=2, max_len=64, chunk=2)
        r1 = srv.submit(p1, 12)
        srv.step()  # p1 is mid-decode
        r2 = srv.submit(p2, 8)  # joins the running batch
        out = srv.run()
        outs.append((out[r1], out[r2]))
    for m, t, (p, n) in zip(outs[0], outs[1], ((p1, 12), (p2, 8))):
        np.testing.assert_array_equal(m, t)
        np.testing.assert_array_equal(m, _isolated(jp, p, n))


def test_single_token_budget_and_validation(both):
    jp, tp = both
    srv = LMServer(tp, CFG, max_slots=1, max_len=32, chunk=4)
    rid = srv.submit(np.array([3, 1, 4]), 1)
    np.testing.assert_array_equal(srv.run()[rid], _isolated(jp, np.array([3, 1, 4]), 1))
    with pytest.raises(ValueError, match="empty prompt"):
        srv.submit(np.array([], np.int32), 4)
    with pytest.raises(ValueError, match="exceeds max_len"):
        srv.submit(np.arange(30), 10)  # 30 + 10 > max_len 32
    with pytest.raises(ValueError, match=">= 1"):
        srv.submit(np.array([1, 2]), 0)
    with pytest.raises(ValueError, match="chunk"):
        LMServer(tp, CFG, chunk=0)
    with pytest.raises(ValueError, match="max_slots"):
        LMServer(tp, CFG, max_slots=0)


GATHER_CHILD = r'''
import os, sys
import numpy as np
import torch

torch.set_num_threads(1)
import torch.distributed as dist

out_dir, rank = sys.argv[1], int(sys.argv[2])
dist.init_process_group("gloo", init_method="file://" + os.path.join(out_dir, "rendezvous"),
                        world_size=2, rank=rank)
from dml_tpu_torch.config import MeshSpec
from dml_tpu_torch.inference import generate as tg
from dml_tpu_torch.inference.lm_server import LMServer
from dml_tpu_torch.inference.lm_sharded import replicated_shardings, shard_lm_params
from dml_tpu_torch.parallel.mesh import make_mesh

full = torch.load(os.path.join(out_dir, "params.pt"))
reqs = torch.load(os.path.join(out_dir, "reqs.pt"), weights_only=False)
mesh = make_mesh(MeshSpec(dp=1, tp=2))
srv = LMServer(shard_lm_params(full, mesh), tg.LMConfig(dtype=torch.float32, **reqs["shape"]),
               max_slots=2, max_len=32, chunk=3, gather_shardings=replicated_shardings(full, mesh))
rids = srv.submit_many(reqs["prompts"], reqs["budgets"])
out = srv.run()
held = sum(t.numel() for t in [srv.params["block_0"]["qkv"]["kernel"]])
torch.save({"tokens": [out[r].tolist() for r in rids], "qkv_numel": held},
           os.path.join(out_dir, f"rank{rank}.pt"))
dist.barrier()
print(f"RANK_OK {rank}", flush=True)
'''


def test_gather_form_serves_token_equal(both, tmp_path):
    """The param-gather form (`gather_shardings`, JAX's `_maybe_gather`):
    two gloo ranks each hold half of every sharded leaf, gather the tree
    at each dispatch, and serve JAX generate's tokens, the same on both
    ranks; mixed budgets refill the two slots."""
    import os
    import subprocess
    import sys

    jp, tp = both
    reqs = [(np.array([1, 2, 3]), 6), (np.array([4, 5, 6, 7, 8]), 4), (np.array([9]), 7)]
    torch.save(tp, tmp_path / "params.pt")
    torch.save({"shape": SHAPE, "prompts": [p for p, _ in reqs],
                "budgets": [n for _, n in reqs]}, tmp_path / "reqs.pt")
    (tmp_path / "child.py").write_text(GATHER_CHILD)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, str(tmp_path / "child.py"), str(tmp_path), str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in out, f"rank {r} failed:\n{out}"
    res = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    want = [_isolated(jp, p, n).tolist() for p, n in reqs]
    assert res[0]["tokens"] == res[1]["tokens"] == want
    assert 2 * res[0]["qkv_numel"] == tp["block_0"]["qkv"]["kernel"].numel()


def test_submit_many_matches_sequential_submit(both):
    jp, tp = both
    prompts = [np.array([1, 2, 3], np.int32), np.array([4, 5], np.int32), np.array([6], np.int32)]
    a = LMServer(tp, CFG, max_slots=2, max_len=32, chunk=4)
    rids_a = [a.submit(p, 6) for p in prompts]
    out_a = a.run()
    b = LMServer(tp, CFG, max_slots=2, max_len=32, chunk=4)
    rids_b = b.submit_many(prompts, 6)
    out_b = b.run()
    j = JaxServer(jp, JCFG, max_slots=2, max_len=32, chunk=4)
    rids_j = j.submit_many(prompts, 6)
    out_j = j.run()
    assert rids_a == rids_b == rids_j
    for ra, rb, rj in zip(rids_a, rids_b, rids_j):
        np.testing.assert_array_equal(out_a[ra], out_b[rb])
        np.testing.assert_array_equal(out_b[rb], out_j[rj])


def test_submit_many_validates_before_queueing(both):
    _, tp = both
    srv = LMServer(tp, CFG, max_slots=2, max_len=8, chunk=2)
    with pytest.raises(ValueError, match="exceeds max_len"):
        srv.submit_many([np.array([1, 2], np.int32), np.arange(7, dtype=np.int32)], 4)
    assert not srv._queue and not srv.has_work()
    with pytest.raises(ValueError, match="budgets for"):
        srv.submit_many([np.array([1], np.int32)], [1, 2])
    with pytest.raises(ValueError, match="on_token callbacks"):
        srv.submit_many([np.array([1], np.int32)], 2, on_token=[None, None])


def test_mixed_budgets_exact_and_slots_refill(both):
    jp, tp = both
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, CFG.vocab_size, 4 + 2 * i) for i in range(5)]
    budgets = [2, 9, 4, 7, 3]
    srv = LMServer(tp, CFG, max_slots=2, max_len=64, chunk=3)
    rids = srv.submit_many(prompts, budgets)
    out = srv.run()
    js = JaxServer(jp, JCFG, max_slots=2, max_len=64, chunk=3)
    jrids = js.submit_many(prompts, budgets)
    jout = js.run()
    for rid, jrid, p, b in zip(rids, jrids, prompts, budgets):
        np.testing.assert_array_equal(out[rid], jout[jrid])
        np.testing.assert_array_equal(out[rid], _isolated(jp, p, b), err_msg=f"req {rid}")


def test_run_with_rids_leaves_other_results(both):
    jp, tp = both
    srv = LMServer(tp, CFG, max_slots=2, max_len=32, chunk=2)
    pa, pb = np.array([1, 2], np.int32), np.array([3, 4, 5], np.int32)
    ra = srv.submit(pa, 4)
    rb = srv.submit(pb, 3)
    out = srv.run([rb])
    assert set(out) == {rb}
    np.testing.assert_array_equal(out[rb], _isolated(jp, pb, 3))
    left = srv.run([ra])
    assert set(left) == {ra}
    np.testing.assert_array_equal(left[ra], _isolated(jp, pa, 4))


def test_metrics_counters_after_mixed_budget_serve(both):
    """The serve loop's registry counters (the port's own registry, the
    JAX package's metric names): every request, every delivered token,
    queue waits and step timings, as deltas of the process-wide registry."""
    _, tp = both
    c_req = METRICS.counter("lm_server_requests_total")
    c_done = METRICS.counter("lm_server_requests_completed_total")
    c_tok = METRICS.counter("lm_server_decode_tokens_total")
    c_steps = METRICS.counter("lm_server_steps_total")
    h_wait = METRICS.histogram("lm_server_queue_wait_seconds")
    h_step = METRICS.histogram("lm_server_step_seconds")
    h_prefill = METRICS.histogram("lm_server_prefill_dispatch_seconds")
    g_slots = METRICS.gauge("lm_server_slots_active")
    g_total = METRICS.gauge("lm_server_slots_total")

    def hist_count(h):
        return sum(st[0] for _, st in h.items())

    before = (c_req.value(), c_done.value(), c_tok.value(), c_steps.value(), hist_count(h_wait),
              hist_count(h_step), hist_count(h_prefill))
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, CFG.vocab_size, 4 + 2 * i) for i in range(5)]
    budgets = [2, 9, 4, 7, 3]
    srv = LMServer(tp, CFG, max_slots=2, max_len=64, chunk=3)
    srv.submit_many(prompts, budgets)
    srv.run()
    assert c_req.value() - before[0] == len(prompts)
    assert c_done.value() - before[1] == len(prompts)
    assert c_tok.value() - before[2] == sum(budgets) == srv.tokens_delivered
    assert c_steps.value() - before[3] >= math.ceil((max(budgets) - 1) / 3)
    assert hist_count(h_wait) - before[4] == len(prompts)
    assert hist_count(h_step) - before[5] == c_steps.value() - before[3]
    assert hist_count(h_prefill) - before[6] >= 1
    assert g_slots.value() == 0.0
    assert g_total.value() == 2.0


def test_each_step_reads_back_once(both, monkeypatch):
    """The one-readback discipline, counted on the CPU: a step (placement
    included) moves data to the host by exactly one `.cpu()` of the
    packed tokens, and never calls item(), tolist() or int() on a tensor."""
    _, tp = both
    calls = {"cpu": 0, "item": 0, "tolist": 0, "int": 0}
    for name, key in (("cpu", "cpu"), ("item", "item"), ("tolist", "tolist"), ("__int__", "int")):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _key=key, **k):
            calls[_key] += 1
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    rng = np.random.RandomState(12)
    srv = LMServer(tp, CFG, max_slots=2, max_len=64, chunk=3)
    srv.submit_many([rng.randint(0, 61, 5 + 4 * i) for i in range(5)], [2, 7, 4, 5, 3])
    steps = 0
    while srv.has_work():
        before = dict(calls)
        srv.step()
        steps += 1
        delta = {k: calls[k] - before[k] for k in calls}
        assert delta == {"cpu": 1, "item": 0, "tolist": 0, "int": 0}, (steps, delta)
    assert steps >= 4


def test_sampled_request_independent_of_batch(both):
    """temperature > 0: a request's sampled tokens are a pure function of
    (seed, rid, positions), whatever shares the grid with it."""
    _, tp = both
    rng = np.random.RandomState(5)
    pa = rng.randint(0, CFG.vocab_size, 9)
    pb = rng.randint(0, CFG.vocab_size, 14)
    pc = rng.randint(0, CFG.vocab_size, 30)

    def serve(prompts_budgets, seed=7):
        srv = LMServer(tp, CFG, max_slots=3, max_len=64, chunk=3, temperature=0.8, top_k=20,
                       seed=seed)
        rids = [srv.submit(p, n) for p, n in prompts_budgets]
        return srv.run(), rids

    alone, (ra,) = serve([(pa, 10)])
    packed, (ra2, rb, rc) = serve([(pa, 10), (pb, 6), (pc, 12)])
    np.testing.assert_array_equal(alone[ra], packed[ra2])
    assert len(packed[rb]) == 6 and len(packed[rc]) == 12
    assert all(0 <= t < CFG.vocab_size for t in packed[rc])
    other_seed, (ra3,) = serve([(pa, 10)], seed=8)
    greedy = _serve(LMServer, tp, CFG, [(pa, 10)], max_slots=3, max_len=64, chunk=3)[0]
    # a different seed, or greedy decoding, gives another stream
    assert not (np.array_equal(other_seed[ra3], alone[ra]) and np.array_equal(greedy, alone[ra]))


def test_sample_per_request_is_a_pure_function_of_seed_rid_pos():
    """The sampler's contract, row by row: the same (seed, rid, pos,
    logits) give the same token whatever the other rows hold; top_k=1 is
    argmax; a changed pos moves the draw; the uniforms lie in (0, 1)."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn((6, 61), generator=g)
    rid = torch.tensor([1, 2, 3, 4, 5, 6], dtype=torch.int32)
    pos = torch.tensor([9, 9, 30, 4, 4, 100], dtype=torch.int32)
    full = tg.sample_per_request(logits, 7, rid, pos, 0.8, 20)
    assert full.dtype == torch.int32
    for i in range(6):
        alone = tg.sample_per_request(logits[i:i + 1], 7, rid[i:i + 1], pos[i:i + 1], 0.8, 20)
        assert int(alone[0]) == int(full[i])
    noisy = logits.clone()
    noisy[1:] = torch.randn((5, 61), generator=g)
    assert int(tg.sample_per_request(noisy, 7, rid, pos, 0.8, 20)[0]) == int(full[0])
    assert torch.equal(tg.sample_per_request(logits, 7, rid, pos, 0.8, 1), logits.argmax(-1).int())
    assert torch.equal(tg.sample_per_request(logits, 7, rid, pos, 0.0, None), logits.argmax(-1).int())
    u = tg.request_uniforms(7, rid, pos, 61)
    assert u.shape == (6, 61) and float(u.min()) > 0.0 and float(u.max()) < 1.0
    assert torch.equal(u, tg.request_uniforms(7, rid, pos, 61))
    assert not torch.equal(u, tg.request_uniforms(7, rid, pos + 1, 61))
    assert not torch.equal(u, tg.request_uniforms(8, rid, pos, 61))
    # a flat distribution over many draws: each of 61 tokens near 1/61
    many = tg.request_uniforms(3, torch.arange(4000), torch.zeros(4000, dtype=torch.int32), 61)
    assert abs(float(many.mean()) - 0.5) < 0.01
    flat = tg.sample_per_request(torch.zeros((4000, 61)), 3, torch.arange(4000),
                                 torch.zeros(4000, dtype=torch.int32), 1.0, None)
    counts = torch.bincount(flat.long(), minlength=61).float()
    assert float(counts.min()) > 30 and float(counts.max()) < 110


def test_freed_slot_steps_far_past_max_len_in_range(both):
    """A freed slot keeps stepping with the grid: its position is clamped
    to the last cache row and carried clamped, so it never writes out of
    range (on the CPU an out-of-range index write raises), and the next
    request placed in that slot is still exact."""
    jp, tp = both
    rng = np.random.RandomState(13)
    short, long_ = rng.randint(0, 61, 6), rng.randint(0, 61, 5)
    srv = LMServer(tp, CFG, max_slots=2, max_len=24, chunk=4)
    r_short = srv.submit(short, 2)
    r_long = srv.submit(long_, 19)  # 5 + 19 == max_len
    out = srv.run()
    # the freed slot stepped 4 tokens a dispatch for ~5 dispatches: far
    # past max_len unclamped; clamped it pins at max_len
    assert int(srv._pos_dev.max()) <= srv.max_len
    np.testing.assert_array_equal(out[r_short], _isolated(jp, short, 2))
    np.testing.assert_array_equal(out[r_long], _isolated(jp, long_, 19))
    # keep stepping the idle grid's slots through many more dispatches
    late = rng.randint(0, 61, 4)
    r_late = srv.submit(late, 20)
    busy = srv.submit(rng.randint(0, 61, 3), 1)
    out = srv.run()
    assert int(srv._pos_dev.max()) <= srv.max_len
    np.testing.assert_array_equal(out[r_late], _isolated(jp, late, 20))
    assert len(out[busy]) == 1


# -- LMDriver ----------------------------------------------------------


def test_driver_single_ticket_matches_jax(both):
    jp, tp = both
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, CFG.vocab_size, 5 + 4 * i) for i in range(3)]
    drv = LMDriver(LMServer(tp, CFG, max_slots=2, max_len=64, chunk=4))
    try:
        outs = drv.serve(prompts, 8)
    finally:
        drv.stop()
    assert drv.tickets_served == 1 and drv.steps >= 2
    for p, o in zip(prompts, outs):
        np.testing.assert_array_equal(o, _isolated(jp, p, 8))


def test_driver_concurrent_tickets_are_exact(both):
    """Many callers at once, their prompts interleaved into one grid: each
    gets what isolated generate gives."""
    jp, tp = both
    rng = np.random.RandomState(7)
    batches = [[rng.randint(0, CFG.vocab_size, int(rng.randint(3, 20))) for _ in range(3)]
               for _ in range(4)]
    drv = LMDriver(LMServer(tp, CFG, max_slots=3, max_len=64, chunk=3))
    results = [None] * len(batches)
    errors = []

    def worker(i):
        try:
            results[i] = drv.serve(batches[i], 7)
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(batches))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        drv.stop()
    assert not errors, errors
    assert drv.tickets_served == 4
    for batch, outs in zip(batches, results):
        assert outs is not None
        for p, o in zip(batch, outs):
            np.testing.assert_array_equal(o, _isolated(jp, p, 7))


def test_driver_on_dispatch_fires_before_completion(both):
    _, tp = both
    drv = LMDriver(LMServer(tp, CFG, max_slots=1, max_len=32, chunk=2))
    fired = threading.Event()
    try:
        out = drv.serve([np.array([1, 2, 3], np.int32)], 6, on_dispatch=fired.set)
    finally:
        drv.stop()
    assert fired.is_set() and len(out[0]) == 6


def test_driver_validation_error_propagates_to_caller(both):
    jp, tp = both
    drv = LMDriver(LMServer(tp, CFG, max_slots=1, max_len=8, chunk=2))
    try:
        with pytest.raises(ValueError, match="exceeds max_len"):
            drv.serve([np.arange(7, dtype=np.int32)], 4)
        out = drv.serve([np.array([1, 2], np.int32)], 3)
        np.testing.assert_array_equal(out[0], _isolated(jp, np.array([1, 2]), 3))
    finally:
        drv.stop()


def test_driver_rejects_after_stop(both):
    _, tp = both
    drv = LMDriver(LMServer(tp, CFG, max_slots=1, max_len=32, chunk=2))
    assert len(drv.serve([np.array([4, 2], np.int32)], 2)[0]) == 2
    drv.stop()
    drv.stop()  # idempotent
    with pytest.raises(RuntimeError, match="stopped"):
        drv.serve([np.array([1], np.int32)], 2)


def test_driver_thread_death_fails_tickets_not_hangs(both):
    """A device error mid-step fails every in-flight serve() call instead
    of leaving it blocked, and the driver then rejects new work."""
    _, tp = both
    srv = LMServer(tp, CFG, max_slots=1, max_len=32, chunk=2)

    def exploding_step():
        raise RuntimeError("device fell over")

    srv.step = exploding_step
    drv = LMDriver(srv)
    with pytest.raises(RuntimeError, match="LMDriver thread died"):
        drv.serve([np.array([1, 2], np.int32)], 4)
    with pytest.raises(RuntimeError):
        drv.serve([np.array([3], np.int32)], 2)


def test_on_token_streams_equal_final_result(both):
    """Every delivered token fires its request's on_token from the packed
    readbacks (first tokens included), and the stream equals the result."""
    jp, tp = both
    rng = np.random.RandomState(14)
    prompts = [rng.randint(0, 61, 5 + 2 * i) for i in range(3)]
    got = {i: [] for i in range(3)}
    srv = LMServer(tp, CFG, max_slots=2, max_len=64, chunk=3)
    rids = srv.submit_many(prompts, [6, 1, 4],
                           on_token=[(lambda t, i=i: got[i].append(t)) for i in range(3)])
    out = srv.run()
    for i, (rid, p, n) in enumerate(zip(rids, prompts, [6, 1, 4])):
        assert got[i] == out[rid].tolist()
        np.testing.assert_array_equal(out[rid], _isolated(jp, p, n))


@pytest.fixture(scope="module")
def moe_both():
    """The same, with block_1's FFN a mixture of 4 experts (LMConfig has no
    MoE field: the servers read the layout from the tree)."""
    model = JaxLM(dtype=jnp.float32, num_experts=4, moe_every=2, **SHAPE)
    jp = model.init(jax.random.PRNGKey(2), jnp.zeros((1, 8), jnp.int32))["params"]
    assert "moe" in jp["block_1"]
    return jp, lm_params_from_flax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def test_moe_tree_matches_jax_server_and_generate(moe_both):
    """An MoE tree served unchanged: mixed budgets, more requests than
    slots, a prompt past the 16-token bucket; tokens equal the JAX
    server's and JAX generate's, and the port's LMDriver gives the same."""
    rng = np.random.RandomState(8)
    reqs = [(rng.randint(0, CFG.vocab_size, t), n) for t, n in ((7, 12), (16, 5), (23, 9), (4, 6))]
    _check_three_ways(moe_both, reqs, max_slots=2, max_len=64, chunk=3)
    drv = LMDriver(LMServer(moe_both[1], CFG, max_slots=2, max_len=64, chunk=3))
    try:
        outs = drv.serve([p for p, _ in reqs], [n for _, n in reqs])
    finally:
        drv.stop()
    for o, (p, n) in zip(outs, reqs):
        np.testing.assert_array_equal(o, _isolated(moe_both[0], p, n))
