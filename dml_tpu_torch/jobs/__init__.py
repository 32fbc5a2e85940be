"""ML job pipeline: intake, batching, fair-share scheduling, execution.

The port's copy of dml_tpu/jobs/ (plain Python; the worker drives the
port's `InferenceEngine` and `LMBackend`). A rebuild of the reference's L7 (worker.py:176-495, 518-537,
887-1026) — see `cost_model` (analytical model + fair split),
`scheduler` (pure-logic coordinator state machine), `service` (the
Node-attached I/O wiring), and `groups` (tensor-parallel worker
groups: a set of nodes pooling chips into one dp×tp scheduler slot).
"""

from .cost_model import (
    ModelCost, batch_exec_time, fair_split, fair_split_weighted,
    query_rate,
)
from .groups import GroupDegraded, GroupDirectory
from .scheduler import Batch, JobState, Scheduler
from .service import JobService

__all__ = [
    "ModelCost",
    "batch_exec_time",
    "query_rate",
    "fair_split",
    "fair_split_weighted",
    "Batch",
    "JobState",
    "Scheduler",
    "JobService",
    "GroupDegraded",
    "GroupDirectory",
]
