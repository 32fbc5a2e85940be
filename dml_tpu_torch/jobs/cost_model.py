"""Analytical cost model + fair-share VM split.

The reference predicts a batch's wall time on a worker VM as

    T(B) = download*B + load + first + per_image*(B-1)

(models.py:128-139) with constants measured once on CPU and hardcoded
(worker.py:57-89). Its scheduler then picks the VM split between the
two active models that minimizes the *relative difference of their
query rates* (worker.py:303-324).

The accelerator's cost structure differs in two ways, so the model is a
parameterized dataclass rather than baked constants:

- both models stay resident in device memory, so `load` is paid once per worker
  lifetime, not per batch; the steady-state per-batch time is
  `download*B + first_amortized + per_query*B` where `first` only
  matters right after a batch-size change (recompile);
- `per_query` on the device is the batch step time / B measured by the
  engine at warmup (engine.cost_constants), typically two orders of
  magnitude below the reference's 250-325 ms/image CPU numbers.

The split search itself is the reference's exact semantics: enumerate
all (i, j) with i+j == n_workers, i,j >= 1, pick the argmin of
|rate_a - rate_b| / max(rate_a, rate_b).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple


@dataclass(frozen=True)
class ModelCost:
    """Per-model scheduling constants (reference ModelParameters,
    models.py:128-139). `resident=True` is the accelerator regime: weights
    stay in device memory so load time is excluded from steady-state batches."""

    load_time: float
    first_query: float
    per_query: float
    download_time: float = 0.05
    batch_size: int = 32
    resident: bool = True

    def with_measurements(
        self,
        load_time: Optional[float] = None,
        first_query: Optional[float] = None,
        per_query: Optional[float] = None,
        batch_size: Optional[int] = None,
    ) -> "ModelCost":
        """Fold in engine warmup measurements (the reference hardcodes
        its constants; we re-measure on the real device)."""
        kw = {}
        if load_time is not None:
            kw["load_time"] = load_time
        if first_query is not None:
            kw["first_query"] = first_query
        if per_query is not None:
            kw["per_query"] = per_query
        if batch_size is not None:
            kw["batch_size"] = batch_size
        return replace(self, **kw)


def batch_exec_time(cost: ModelCost, batch: Optional[int] = None) -> float:
    """Predicted wall time of one batch on one worker.

    Reference formula (models.py:138-139): dl*B + load + first + per*(B-1).
    The resident steady state drops the per-batch `load` and folds `first` into
    compile-time only; one batched forward costs per_query*B.
    """
    b = batch if batch is not None else cost.batch_size
    if b <= 0:
        return 0.0
    if cost.resident:
        return cost.download_time * b + cost.per_query * b
    return cost.download_time * b + cost.load_time + cost.first_query + cost.per_query * (b - 1)


def query_rate(
    cost: ModelCost, n_workers: float, batch: Optional[int] = None
) -> float:
    """Predicted queries/sec with `n_workers` VMs running this model
    (reference: rate = vms * batch_size / exec_time, worker.py:303-324).

    `n_workers` may be a float: a tensor-parallel worker GROUP
    (jobs/groups.py) counts as one pool slot with capacity = its
    measured/estimated throughput multiple of a single chip, so the
    fair split sees aggregate rate, not slot count."""
    b = batch if batch is not None else cost.batch_size
    t = batch_exec_time(cost, b)
    if t <= 0 or n_workers <= 0:
        return 0.0
    return n_workers * b / t


def overlap_headroom(
    fetch_s: float, decode_s: float, infer_s: float, put_s: float
) -> float:
    """Analytic upper bound on the depth-2 worker-pipelining speedup
    given measured per-batch stage walls.

    Depth-2 staging overlaps batch N+1's prepare (store fetch + host
    decode) with batch N's in-flight inference; the PUT and residue
    stay serial. Perfect overlap takes the serial wall
    ``prep + infer + put`` to ``max(prep, infer) + put``, so the bound
    is their ratio — ≤ (prep+infer)/max(prep,infer) ≤ 2. A bound near
    1.0 predicts the overlap state machine cannot pay for itself (a
    fast link, prep ≪ infer); the DepthController's probe
    is the measurement this prior is checked against, never a
    substitute for it.
    """
    prep = max(fetch_s + decode_s, 0.0)
    infer = max(infer_s, 0.0)
    put = max(put_s, 0.0)
    serial = prep + infer + put
    overlapped = max(prep, infer) + put
    if overlapped <= 0.0 or serial <= 0.0:
        return 1.0
    return round(serial / overlapped, 3)


def fair_split(
    n_workers: int, cost_a: ModelCost, cost_b: ModelCost
) -> Tuple[int, int]:
    """Split `n_workers` between two active models to minimize the
    relative difference of their predicted query rates (the reference's
    dual-model case, worker.py:303-324: enumerate every split, argmin
    |r_a - r_b| / max). Each model gets at least one worker when
    n_workers >= 2."""
    return fair_split_weighted([1.0] * max(0, n_workers), cost_a, cost_b)


def fair_split_weighted(
    weights: Sequence[float], cost_a: ModelCost, cost_b: ModelCost
) -> Tuple[int, int]:
    """`fair_split` over a pool whose slots have unequal capacity.

    A tensor-parallel worker group (jobs/groups.py) occupies ONE pool
    slot but serves with the aggregate throughput of its members, so
    each slot carries a weight (single chip = 1.0, a formed group =
    its capacity). The enumeration is the reference's exact shape —
    every contiguous split of the pool, argmin of the relative rate
    difference — run over the pool sorted by weight DESCENDING and
    scored with weighted rates, with both assignment directions tried
    (the heavy group going to model A or to model B are different
    splits). Uniform weights reduce this to the reference's
    `fair_split` bit-for-bit.

    Returns (count_for_a, count_for_b); with heterogeneous weights the
    counts mean "model a takes that many of the heaviest slots" when
    the directed form says so — schedulers that place work should use
    `fair_split_weighted_directed`, which also returns WHICH model the
    heavy prefix belongs to, and grow that model heaviest-slot-first.
    """
    i, j, _ = fair_split_weighted_directed(weights, cost_a, cost_b)
    return (i, j)


def class_split(
    n_slots: int,
    cost: ModelCost,
    weight_a: float,
    weight_b: float,
) -> Tuple[int, int]:
    """Split `n_slots` free workers between TWO SLO classes of one
    model in proportion to their weights, through the SAME fair-split
    enumeration the dual-model scheduler uses: each class presents the
    model's cost with its exec time scaled BY its weight. Since
    ``query_rate ∝ capacity / exec``, equalizing the scaled rates
    allocates capacity ∝ weight — interactive at weight 3 vs batch at
    1 converges to a 3:1 slot share, with fair_split's granularity
    handling (each class gets at least one slot when n >= 2) for
    free."""
    if n_slots <= 0:
        return (0, 0)
    wa = max(float(weight_a), 1e-9)
    wb = max(float(weight_b), 1e-9)

    def scaled(w: float) -> ModelCost:
        return replace(
            cost,
            first_query=cost.first_query * w,
            per_query=cost.per_query * w,
            download_time=cost.download_time * w,
            load_time=cost.load_time * w,
        )

    return fair_split_weighted(
        [1.0] * n_slots, scaled(wa), scaled(wb)
    )


def fair_split_weighted_directed(
    weights: Sequence[float], cost_a: ModelCost, cost_b: ModelCost
) -> Tuple[int, int, bool]:
    """`fair_split_weighted` plus the placement direction: returns
    ``(count_for_a, count_for_b, a_heavy)`` where ``a_heavy`` means
    model a's count refers to the HEAVIEST slots of the pool (else
    model b's does). Counts alone can't carry that — (1, 3) over
    weights [2,1,1,1] is balanced only if the 1 IS the weight-2 slot —
    so the caller must assign the heavy-side model its workers in
    descending-weight order."""
    n = len(weights)
    if n <= 0:
        return (0, 0, True)
    if n == 1:
        # single slot: give it to the slower model (higher per-query
        # time) so the worst-case rate is maximized
        return (
            (1, 0, True)
            if batch_exec_time(cost_a) >= batch_exec_time(cost_b)
            else (0, 1, False)
        )
    w = sorted((float(x) for x in weights), reverse=True)
    prefix = [0.0]
    for x in w:
        prefix.append(prefix[-1] + x)
    best = (1, n - 1, True)
    best_score = float("inf")
    # two passes, reference order first: with uniform weights every
    # pass-2 candidate duplicates a pass-1 capacity pair, so the
    # strict-< replacement keeps pass 1's (= the reference's) winner
    # including its tie-breaking order
    for a_heavy in (True, False):
        for i in range(1, n):
            j = n - i
            heavy, light = prefix[i], prefix[n] - prefix[i]
            cap_a, cap_b, split = (
                (heavy, light, (i, j, True)) if a_heavy
                else (light, heavy, (j, i, False))
            )
            ra = query_rate(cost_a, cap_a)
            rb = query_rate(cost_b, cap_b)
            hi = max(ra, rb)
            score = abs(ra - rb) / hi if hi > 0 else 0.0
            if score < best_score:
                best_score = score
                best = split
    return best
