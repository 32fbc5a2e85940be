"""SLO classes and admission math for the request front door.

A request enters the cluster with an SLO *class* — a named deadline
tier (``interactive``: sub-second-ish answers for a human waiting;
``batch``: minutes-scale background work). The class decides three
things, all computed here as pure functions so they are deterministic
and unit-testable with injected clocks:

- the request's **deadline** (arrival + ``deadline_s``),
- its **admission**: a request the cluster already knows it cannot
  finish inside the deadline is *shed* at the door with a typed
  rejection (reason string), never left to time out in a queue — the
  open-loop load regime's cardinal rule (arxiv 2605.25645 scores
  exactly this: goodput under an SLO, not raw completions),
- its batch's **dispatch-by time**: the deadline-derived slack that
  continuous batch formation (ingress/router.py) spends waiting for
  co-batchable requests before it must dispatch a partial batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class SLOClass:
    """One deadline tier.

    ``deadline_s``    end-to-end budget from admission to completion.
    ``queue_limit``   max requests of this class pending (forming +
                      dispatched, not yet terminal) before the door
                      sheds — the backpressure bound that keeps a
                      saturated cluster's queue from growing without
                      limit (queue growth under open-loop load is
                      unbounded by construction; only shedding stops it).
    ``linger_s``      minimum time a fresh forming batch waits for
                      co-batchable arrivals when the pipeline is hungry
                      (light-load coalescing window; keep it well under
                      the deadline).
    """

    name: str
    deadline_s: float
    queue_limit: int = 1024
    linger_s: float = 0.02


#: default tiers; operators override per-router
DEFAULT_CLASSES: Dict[str, SLOClass] = {
    "interactive": SLOClass("interactive", deadline_s=2.0,
                            queue_limit=256, linger_s=0.02),
    "batch": SLOClass("batch", deadline_s=30.0,
                      queue_limit=4096, linger_s=0.10),
    # TrainJob step jobs (jobs/train.py): deadline-tolerant throughput
    # work — the scheduler's class weight (train: 0.5, below batch)
    # is what actually protects interactive p99; the loose deadline
    # here just keeps a step job from ever being shed at the door
    "train": SLOClass("train", deadline_s=120.0,
                      queue_limit=64, linger_s=0.10),
}


#: per-class SLO error budgets: the fraction of requests a class may
#: miss/shed before its budget is spent at burn-rate 1.0 (the signal
#: plane's burn monitors divide the observed bad fraction by this).
#: Interactive work gets the tight budget; batch work tolerates more.
DEFAULT_BURN_BUDGETS: Dict[str, float] = {
    "interactive": 0.02,
    "batch": 0.05,
}

#: fallback budget for scopes without an entry (per-model monitors,
#: operator-defined classes): permissive, so an unknown scope cannot
#: page at the interactive threshold by accident
DEFAULT_BURN_BUDGET = 0.05


def burn_budget(name: str) -> float:
    """The SLO error budget for a class (or any monitor scope)."""
    return DEFAULT_BURN_BUDGETS.get(name, DEFAULT_BURN_BUDGET)


def resolve_class(
    name: str, classes: Optional[Dict[str, SLOClass]] = None
) -> SLOClass:
    classes = classes or DEFAULT_CLASSES
    try:
        return classes[name]
    except KeyError:
        raise KeyError(
            f"unknown SLO class {name!r}; known: {sorted(classes)}"
        ) from None


def shed_reason(
    *,
    now: float,
    deadline: float,
    pending_in_class: int,
    queue_limit: int,
    backlog_batches: int,
    slots: int,
    est_batch_exec_s: Optional[float],
) -> Optional[str]:
    """Admission decision for one request; ``None`` admits.

    Two sheds, checked in order:

    - ``queue_full``: the class already has ``queue_limit`` requests
      pending — per-class backpressure, independent of timing.
    - ``deadline_unmeetable``: queue slack is negative. The projected
      finish is ``now + wait + exec`` where the wait is the scheduler
      backlog drained at ``slots`` batches at a time — if that already
      exceeds the deadline, admitting the request only manufactures a
      guaranteed SLO miss that occupies a queue slot other requests
      could use. The estimate is deliberately simple (measured
      per-batch exec x backlog / slots); it errs permissive, because a
      false shed is a user-visible failure while a false admit merely
      becomes one more late completion. ``est_batch_exec_s=None``
      means the model has NO measured exec yet (cold coordinator,
      fresh failover promotion) — the slack check is skipped entirely
      rather than trusted to a prior; only the queue bound sheds.

    A shed gets an immediate typed rejection at the door — never a
    timeout.
    """
    if pending_in_class >= queue_limit:
        return "queue_full"
    if est_batch_exec_s is None:
        return None
    slots = max(1, slots)
    wait_s = (backlog_batches / slots) * est_batch_exec_s
    if now + wait_s + est_batch_exec_s > deadline:
        return "deadline_unmeetable"
    return None
