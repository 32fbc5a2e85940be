"""The port's CheckpointManager, with the contract of the JAX package's
(tests/test_checkpoint.py::test_manager_save_restore_retention), and a
resume through LongContextLM that repeats the same losses bit for bit on
the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from dml_tpu_torch.parallel.checkpoint import CheckpointManager
from dml_tpu_torch.parallel.long_context import LongContextLM

CFG = dict(vocab_size=96, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=64)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    # the tests run beside other test processes on a shared CPU; torch's
    # default of one thread per core oversubscribes it
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_manager_save_restore_retention(tmp_path):
    ck = tmp_path / "ck"
    mgr = CheckpointManager(str(ck), keep=2)
    template = {"w": torch.zeros(3), "step": 0}
    for step in (1, 2, 3):
        mgr.save(step, {"w": torch.full((3,), float(step)), "step": step})
    assert mgr.steps() == [2, 3]  # keep=2 evicted step 1
    assert mgr.latest_step() == 3
    with open(ck / "manifest.json") as f:
        assert json.load(f) == {"steps": [2, 3]}
    assert sorted(os.listdir(ck)) == ["manifest.json", "step_2.pt", "step_3.pt"]  # no .tmp left
    st = mgr.restore(template)
    assert st["step"] == 3 and torch.equal(st["w"], torch.full((3,), 3.0))
    st2 = mgr.restore(template, step=2)
    assert torch.equal(st2["w"], torch.full((3,), 2.0))
    with pytest.raises(KeyError, match="expected"):
        mgr.restore({"w": torch.zeros(3)})
    # numpy leaves are stored as tensors; a fresh manager reads the manifest
    mgr.save(4, {"w": np.arange(3, dtype=np.float32), "step": np.int32(4)})
    again = CheckpointManager(str(ck), keep=2)
    assert again.steps() == [3, 4] and not (ck / "step_2.pt").exists()
    st4 = again.restore(template)
    assert st4["step"] == 4 and torch.equal(st4["w"], torch.arange(3, dtype=torch.float32))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(template)


def test_long_context_resume_repeats_the_losses(tmp_path):
    lm = LongContextLM(seq_len=32, dtype=torch.float32, device="cpu", seed=1, **CFG)
    toks = np.random.RandomState(0).randint(0, CFG["vocab_size"], (2, 32)).astype(np.int32)
    for _ in range(2):
        lm.train_step(toks)
    path = lm.save_checkpoint(str(tmp_path / "ck"), keep=2)
    assert os.path.basename(path) == "step_2.pt"
    after = [lm.train_step(toks) for _ in range(2)]
    lm.save_checkpoint(str(tmp_path / "ck"), keep=2)
    assert lm.restore_checkpoint(str(tmp_path / "ck"), step=2) == 2
    assert lm.state["opt_state"]["count"] == 2
    assert [lm.train_step(toks) for _ in range(2)] == after  # bit for bit
    # a new LM restored from the latest checkpoint continues the same way
    lm2 = LongContextLM(seq_len=32, dtype=torch.float32, device="cpu", seed=7, **CFG)
    assert lm2.restore_checkpoint(str(tmp_path / "ck")) == 4
    assert lm2.train_step(toks) == lm.train_step(toks)
