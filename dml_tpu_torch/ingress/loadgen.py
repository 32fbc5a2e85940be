"""Open-loop load generator for the request front door.

Closed-loop drivers (submit, wait, submit again — every prior bench
phase worked this way) hide overload: a slow server slows the *driver*
down, so measured latency stays flat while real users would be piling
up. The serving literature scores the **open-loop** regime instead
(arxiv 2605.25645): arrivals follow a fixed trace regardless of how
the server is doing, so queueing delay and shedding show up exactly
as a user population would feel them.

Three pieces, all deterministic:

- ``ArrivalTrace`` / ``open_loop_trace(seed, ...)`` — a seeded
  Poisson-process arrival schedule with per-request model / SLO-class
  / session draws. Same seed => byte-identical trace (asserted by a
  JSON round-trip test); traces serialize so a bench run's workload
  can be re-issued verbatim.
- ``run_open_loop(submit, trace)`` — fire each arrival at its trace
  time (never gated on earlier completions), collect one terminal
  ``Outcome`` per request.
- ``summarize(outcomes, wall_s)`` — tail-latency scoring: p50/p95/p99
  over requests that COMPLETED (shed requests are counted as
  rejections and excluded from the latency distribution — a latency
  percentile that averages in instant rejections would flatter the
  tail), goodput (completions inside their deadline per second), and
  the shed ratio.
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
import random
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Awaitable, Callable, Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Arrival:
    """One scheduled request: fire at trace start + ``t`` seconds.

    ``turn`` > 0 marks a CHAINED multi-turn session request
    (`multi_turn_trace` / `run_sessions`): turn N's prompt is the
    session's accumulated history (prior prompts + completions) plus
    this arrival's seeded ``suffix`` token ids, so consecutive turns
    share a growing token prefix — the workload shape the worker-
    resident KV prefix cache (inference/kv_cache.py) exists for.
    ``budget`` is the per-request generation budget those prompts
    carry (0 = the driver's default). Plain open-loop arrivals keep
    turn == 0 and no suffix."""

    t: float
    model: str
    slo: str
    session: Optional[str] = None
    stream: bool = False
    turn: int = 0
    suffix: Optional[Tuple[int, ...]] = None
    budget: int = 0


@dataclass
class ArrivalTrace:
    seed: int
    duration_s: float
    rate_qps: float
    arrivals: List[Arrival] = field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps(
            {
                "seed": self.seed,
                "duration_s": self.duration_s,
                "rate_qps": self.rate_qps,
                "arrivals": [asdict(a) for a in self.arrivals],
            },
            separators=(",", ":"),
        )

    @classmethod
    def from_json(cls, text: str) -> "ArrivalTrace":
        d = json.loads(text)
        return cls(
            seed=int(d["seed"]),
            duration_s=float(d["duration_s"]),
            rate_qps=float(d["rate_qps"]),
            # suffix rides JSON as a list; the dataclass keeps a tuple
            # so a round-tripped trace re-serializes byte-identically
            arrivals=[
                Arrival(**{
                    **a,
                    "suffix": (
                        tuple(a["suffix"])
                        if a.get("suffix") is not None else None
                    ),
                })
                for a in d["arrivals"]
            ],
        )


def open_loop_trace(
    seed: int,
    duration_s: float,
    rate_qps: float,
    model: str = "stub",
    slo_mix: Optional[Dict[str, float]] = None,
    session_pct: float = 0.0,
    n_sessions: int = 8,
    stream_pct: float = 0.0,
) -> ArrivalTrace:
    """Seeded Poisson arrivals at ``rate_qps`` for ``duration_s``.

    ``slo_mix`` maps class name -> weight (default all interactive);
    ``session_pct`` percent of requests carrying a session id (drawn
    from ``n_sessions`` stable ids — multi-turn affinity traffic);
    ``stream_pct`` percent requesting token streaming. Every draw
    comes from one ``random.Random(seed)`` in arrival order, so the
    whole trace — times, classes, sessions — replays identically."""
    rng = random.Random(seed)
    mix = list((slo_mix or {"interactive": 1.0}).items())
    total_w = sum(w for _, w in mix) or 1.0
    arrivals: List[Arrival] = []
    t = 0.0
    while True:
        t += rng.expovariate(rate_qps) if rate_qps > 0 else duration_s
        if t >= duration_s:
            break
        x = rng.random() * total_w
        slo = mix[-1][0]
        for name, w in mix:
            if x < w:
                slo = name
                break
            x -= w
        session = (
            f"s{rng.randrange(n_sessions)}"
            if rng.random() * 100.0 < session_pct else None
        )
        stream = rng.random() * 100.0 < stream_pct
        arrivals.append(Arrival(
            t=round(t, 6), model=model, slo=slo,
            session=session, stream=stream,
        ))
    return ArrivalTrace(
        seed=seed, duration_s=duration_s, rate_qps=rate_qps,
        arrivals=arrivals,
    )


def diurnal_trace(
    seed: int,
    duration_s: float,
    base_qps: float,
    peak_qps: float,
    model: str = "stub",
    slo_mix: Optional[Dict[str, float]] = None,
    ramp_frac: float = 0.25,
    plateau_frac: float = 0.35,
    session_pct: float = 0.0,
    n_sessions: int = 8,
    stream_pct: float = 0.0,
) -> ArrivalTrace:
    """Seeded RAMP–PLATEAU–TROUGH arrivals — the diurnal curve the
    autoscaler bench scores static provisioning against. The rate
    envelope climbs from ``base_qps`` to ``peak_qps`` over the first
    ``ramp_frac`` of the run, holds the peak for ``plateau_frac``,
    ramps back down over another ``ramp_frac``, and idles at
    ``base_qps`` for the remaining trough. Arrivals are a
    non-homogeneous Poisson process drawn by THINNING against the peak
    rate — candidate gaps at ``peak_qps``, each kept with probability
    ``rate(t)/peak_qps`` — so every draw still comes from one
    ``random.Random(seed)`` in arrival order and the whole trace
    replays byte-identically (same JSON round-trip contract as
    ``open_loop_trace``). Per-request SLO-class / session / stream
    draws match ``open_loop_trace``'s."""
    rng = random.Random(seed)
    base = max(0.0, float(base_qps))
    peak = max(base, float(peak_qps))
    r = max(0.0, float(ramp_frac)) * duration_s
    p = max(0.0, float(plateau_frac)) * duration_s

    def rate(t: float) -> float:
        if r > 0 and t < r:
            return base + (peak - base) * (t / r)
        if t < r + p:
            return peak
        if r > 0 and t < 2 * r + p:
            return peak - (peak - base) * ((t - r - p) / r)
        return base

    mix = list((slo_mix or {"interactive": 1.0}).items())
    total_w = sum(w for _, w in mix) or 1.0
    arrivals: List[Arrival] = []
    t = 0.0
    while peak > 0:
        t += rng.expovariate(peak)
        if t >= duration_s:
            break
        if rng.random() * peak >= rate(t):
            continue  # thinned: the envelope is below peak here
        x = rng.random() * total_w
        slo = mix[-1][0]
        for name, w in mix:
            if x < w:
                slo = name
                break
            x -= w
        session = (
            f"s{rng.randrange(n_sessions)}"
            if rng.random() * 100.0 < session_pct else None
        )
        stream = rng.random() * 100.0 < stream_pct
        arrivals.append(Arrival(
            t=round(t, 6), model=model, slo=slo,
            session=session, stream=stream,
        ))
    mean = len(arrivals) / duration_s if duration_s > 0 else 0.0
    return ArrivalTrace(
        seed=seed, duration_s=float(duration_s),
        rate_qps=round(mean, 6), arrivals=arrivals,
    )


def multi_turn_trace(
    seed: int,
    n_sessions: int,
    turns: int,
    model: str,
    *,
    slo: str = "interactive",
    start_gap_s: float = 0.5,
    think_s: float = 0.5,
    suffix_len: int = 8,
    vocab: int = 61,
    budget: int = 16,
) -> ArrivalTrace:
    """Seeded GROWING-HISTORY session trace: ``n_sessions`` sessions of
    ``turns`` chained turns each. Turn N's prompt is the session's
    prior prompts + completions plus this turn's seeded ``suffix``
    (drawn from ``vocab``), so consecutive turns extend a shared token
    prefix — the prefix-cache workload. Arrival times stagger session
    starts by ``start_gap_s`` with ``think_s`` between a session's
    turns; `run_sessions` treats them as EARLIEST-fire times (a turn
    additionally waits for its predecessor's completion — closed-loop
    within a session, open-loop across sessions). Same seed =>
    byte-identical trace; JSON round-trips like `open_loop_trace`'s."""
    rng = random.Random(seed)
    arrivals: List[Arrival] = []
    for s in range(n_sessions):
        t0 = round(s * start_gap_s + rng.random() * 0.1, 6)
        for k in range(turns):
            arrivals.append(Arrival(
                t=round(t0 + k * think_s, 6), model=model, slo=slo,
                session=f"mt{seed}s{s}", stream=True, turn=k + 1,
                suffix=tuple(
                    rng.randrange(vocab) for _ in range(suffix_len)
                ),
                budget=int(budget),
            ))
    arrivals.sort(key=lambda a: (a.t, a.session, a.turn))
    duration = max((a.t for a in arrivals), default=0.0) + think_s
    rate = len(arrivals) / duration if duration > 0 else 0.0
    return ArrivalTrace(
        seed=seed, duration_s=round(duration, 6),
        rate_qps=round(rate, 6), arrivals=arrivals,
    )


# ----------------------------------------------------------------------
# outcomes + scoring
# ----------------------------------------------------------------------

#: terminal states (exactly one per request — the front-door contract)
TERMINAL_COMPLETED = "completed"
TERMINAL_SHED = "shed"          # typed rejection at the admission door
TERMINAL_REJECTED = "rejected"  # typed rejection after admission
TERMINAL_LOST = "lost"          # coordinator lost it (failover); the
                                # client converted silence into a typed
                                # terminal — still counted as rejection


@dataclass
class Outcome:
    """One request's terminal record."""

    slo: str
    terminal: str
    e2e_s: Optional[float] = None  # submit -> terminal (completions)
    deadline_met: bool = False
    reason: Optional[str] = None
    model: str = ""
    session: Optional[str] = None
    worker: Optional[str] = None
    #: completions only: the terminal carried actual result payload.
    #: A completed outcome WITHOUT one is the silent-loss failure the
    #: front door types as result_unavailable instead — the failover
    #: bench asserts this never reads False on a completion.
    has_result: bool = False
    #: distributed-tracing join keys (dml_tpu_torch/tracing.py): the trace
    #: id minted at admission and the router's terminal-carried
    #: per-stage seconds — `summarize` joins completions against
    #: pulled cluster traces by trace_id, with `stages` as the
    #: fallback when a trace was sampled away or evicted
    trace_id: Optional[str] = None
    stages: Optional[Dict[str, float]] = None
    #: multi-turn session fields (`run_sessions`): which turn this
    #: outcome belongs to (0 = not chained) and the client-side
    #: time-to-first-token measured at the first streamed chunk —
    #: the warm-vs-cold number the prefix-cache bench phase scores
    turn: int = 0
    ttft_s: Optional[float] = None
    #: time-per-output-token: mean inter-chunk gap over the request's
    #: streamed tokens, (last stamp - first stamp) / (chunks - 1),
    #: from client-side `on_chunk` stamps (None when the request
    #: streamed < 2 chunks or didn't stream). TTFT scores the prefill
    #: + queue story; TPOT scores the DECODE loop — speculative
    #: decoding moves this one.
    tpot_s: Optional[float] = None


def percentile(sorted_vals: Sequence[float], p: float) -> float:
    """Linear-interpolation percentile over an already-sorted sample
    (the NIST/numpy 'linear' definition): rank ``p/100 * (n-1)`` is
    interpolated between its floor and ceiling neighbors. The test
    fixture hand-computes these."""
    if not sorted_vals:
        return math.nan
    if len(sorted_vals) == 1:
        return float(sorted_vals[0])
    rank = (p / 100.0) * (len(sorted_vals) - 1)
    lo = math.floor(rank)
    hi = math.ceil(rank)
    frac = rank - lo
    return float(sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac)


def summarize(
    outcomes: Sequence[Outcome], wall_s: float,
    trace_stages: Optional[Dict[str, Dict[str, float]]] = None,
) -> Dict[str, Any]:
    """Tail-latency + goodput scorecard over one open-loop run.

    Latency percentiles are computed over COMPLETED requests only:
    shed/rejected/lost requests are terminal *rejections* — they are
    counted (``shed`` / ``rejected`` and the ``shed_ratio``) but
    excluded from the latency distribution, because an immediate
    rejection's near-zero "latency" would deflate the percentiles of
    the requests the cluster actually served. Goodput counts only
    completions that made their deadline.

    ``trace_stages`` joins completions against collected traces
    (trace_id -> per-stage seconds, e.g. ``tracing.stage_breakdown``
    over a ``pull_cluster_traces`` result); each completion falls back
    to its terminal-carried ``stages`` when its trace was sampled away
    or evicted. When any join lands, the scorecard gains a
    ``p99_attribution`` block: the mean per-stage breakdown of the
    p99 COHORT (completions at/above the p99 latency) — which hop ate
    the tail, not just how long the tail is."""
    out: Dict[str, Any] = {"n": len(outcomes), "wall_s": round(wall_s, 3)}
    by_class: Dict[str, List[Outcome]] = {}
    for o in outcomes:
        by_class.setdefault(o.slo, []).append(o)

    def score(rows: Sequence[Outcome]) -> Dict[str, Any]:
        lat = sorted(
            o.e2e_s for o in rows
            if o.terminal == TERMINAL_COMPLETED and o.e2e_s is not None
        )
        tpot = sorted(
            o.tpot_s for o in rows
            if o.terminal == TERMINAL_COMPLETED and o.tpot_s is not None
        )
        completed = sum(1 for o in rows if o.terminal == TERMINAL_COMPLETED)
        shed = sum(1 for o in rows if o.terminal == TERMINAL_SHED)
        rejected = sum(
            1 for o in rows
            if o.terminal in (TERMINAL_REJECTED, TERMINAL_LOST)
        )
        good = sum(
            1 for o in rows
            if o.terminal == TERMINAL_COMPLETED and o.deadline_met
        )
        return {
            "n": len(rows),
            "completed": completed,
            "shed": shed,
            "rejected": rejected,
            "goodput_qps": round(good / wall_s, 2) if wall_s > 0 else 0.0,
            "shed_ratio": (
                round((shed + rejected) / len(rows), 4) if rows else 0.0
            ),
            "latency_ms": {
                "p50": round(percentile(lat, 50) * 1e3, 1) if lat else None,
                "p95": round(percentile(lat, 95) * 1e3, 1) if lat else None,
                "p99": round(percentile(lat, 99) * 1e3, 1) if lat else None,
            },
            # decode-loop tail, from client-observed inter-chunk
            # stamps (Outcome.tpot_s); None keys when the run didn't
            # stream — e2e latency folds queue+prefill+decode
            # together, TPOT isolates the decode loop that
            # speculative decoding accelerates
            "tpot_ms": {
                "p50": round(percentile(tpot, 50) * 1e3, 2) if tpot else None,
                "p95": round(percentile(tpot, 95) * 1e3, 2) if tpot else None,
                "p99": round(percentile(tpot, 99) * 1e3, 2) if tpot else None,
            },
        }

    out.update(score(outcomes))
    out["by_class"] = {c: score(rows) for c, rows in sorted(by_class.items())}
    attrib = _p99_attribution(outcomes, trace_stages)
    if attrib is not None:
        out["p99_attribution"] = attrib
    turn_block = _by_turn(outcomes)
    if turn_block is not None:
        out["by_turn"] = turn_block
    return out


def _by_turn(outcomes: Sequence[Outcome]) -> Optional[Dict[str, Any]]:
    """Per-turn TTFT scorecard over chained session outcomes (None
    when the run carried no multi-turn traffic). Turn 1 pays the cold
    prefill either way; turns >= 2 are where a prefix-cache warm
    start shows up as a TTFT drop."""
    rows = [o for o in outcomes if o.turn > 0]
    if not rows:
        return None
    by: Dict[int, List[Outcome]] = {}
    for o in rows:
        by.setdefault(o.turn, []).append(o)
    out: Dict[str, Any] = {}
    for turn, grp in sorted(by.items()):
        tt = sorted(
            o.ttft_s for o in grp
            if o.terminal == TERMINAL_COMPLETED and o.ttft_s is not None
        )
        out[str(turn)] = {
            "n": len(grp),
            "completed": sum(
                1 for o in grp if o.terminal == TERMINAL_COMPLETED
            ),
            "ttft_ms": {
                "p50": round(percentile(tt, 50) * 1e3, 1) if tt else None,
                "mean": (
                    round(sum(tt) / len(tt) * 1e3, 1) if tt else None
                ),
            },
        }
    return out


def _p99_attribution(
    outcomes: Sequence[Outcome],
    trace_stages: Optional[Dict[str, Dict[str, float]]],
) -> Optional[Dict[str, Any]]:
    """Join completions against traces and attribute the p99 cohort's
    time to stages (None when nothing joins — no tracing ran)."""
    from ..tracing import cohort_attribution

    completed = [
        o for o in outcomes
        if o.terminal == TERMINAL_COMPLETED and o.e2e_s is not None
    ]
    if not completed:
        return None
    joined: List[Tuple[Outcome, Dict[str, float]]] = []
    for o in completed:
        stages = None
        if trace_stages and o.trace_id:
            stages = trace_stages.get(o.trace_id)
        if not stages:
            stages = o.stages
        if stages:
            joined.append((o, {
                k: float(v) for k, v in stages.items()
                if isinstance(v, (int, float))
            }))
    if not joined:
        return None
    lats = sorted(o.e2e_s for o in completed)
    p99v = percentile(lats, 99)
    cohort = [(o, s) for o, s in joined if o.e2e_s >= p99v]
    if not cohort:  # every p99-cohort completion failed to join:
        # report the slowest joined completion rather than nothing
        cohort = sorted(joined, key=lambda t: t[0].e2e_s)[-1:]
    attrib = cohort_attribution(
        [s for _, s in cohort], [o.e2e_s for o, _ in cohort]
    )
    attrib["p99_ms"] = round(p99v * 1e3, 1)
    attrib["joined"] = len(joined)
    attrib["completed"] = len(completed)
    attrib["join_fraction"] = round(len(joined) / len(completed), 4)
    return attrib


async def drive_one(
    ingress,
    a: Arrival,
    *,
    store_name: Optional[str] = None,
    submit_timeout: float = 8.0,
    wait_timeout: float = 45.0,
    deadline_by_class: Optional[Dict[str, float]] = None,
    now: Callable[[], float] = time.monotonic,
) -> Outcome:
    """Drive ONE arrival through a RequestRouter's client verbs to a
    terminal Outcome — the shared submit/wait/classify mapping the
    bench's open-loop phases and the CLI ``request-load`` verb both
    use (one copy, so a LOST terminal is classified identically
    everywhere). e2e is measured CLIENT-side (includes the submit
    round trip); ``deadline_by_class`` overrides the router's
    deadline_met with the client-side clock when provided.
    ``store_name`` pins the request to a specific pre-put store input
    instead of the router's sampled default — drivers that need
    per-request work (the diurnal provisioning probe) spread requests
    over distinct inputs so batch-level file dedup cannot collapse
    their cost."""
    from .router import RequestRejected

    t0 = now()
    try:
        rid = await ingress.submit(
            a.model, slo=a.slo, store_name=store_name,
            session=a.session, stream=a.stream,
            timeout=submit_timeout,
        )
    except RequestRejected as e:
        return Outcome(
            slo=a.slo,
            terminal=TERMINAL_SHED if e.shed else TERMINAL_REJECTED,
            reason=e.reason, model=a.model, session=a.session,
        )
    except Exception as e:
        return Outcome(slo=a.slo, terminal=TERMINAL_LOST, reason=repr(e),
                       model=a.model, session=a.session)
    try:
        term = await ingress.wait(rid, timeout=wait_timeout)
    except Exception as e:
        return Outcome(slo=a.slo, terminal=TERMINAL_LOST,
                       reason=f"wait: {e!r}", model=a.model,
                       session=a.session)
    e2e = now() - t0
    if term.get("ok"):
        if deadline_by_class and a.slo in deadline_by_class:
            met = e2e <= deadline_by_class[a.slo]
        else:
            met = bool(term.get("deadline_met"))
        return Outcome(
            slo=a.slo, terminal=TERMINAL_COMPLETED, e2e_s=e2e,
            deadline_met=met, model=a.model, session=a.session,
            worker=term.get("worker"),
            has_result=term.get("result") is not None,
            trace_id=term.get("trace_id"),
            stages=(term.get("stages")
                    if isinstance(term.get("stages"), dict) else None),
        )
    return Outcome(
        slo=a.slo,
        terminal=(TERMINAL_LOST if term.get("terminal") == "lost"
                  else TERMINAL_REJECTED),
        reason=term.get("reason"), model=a.model, session=a.session,
        trace_id=term.get("trace_id"),
    )


async def run_sessions(
    ingress,
    trace: ArrivalTrace,
    *,
    submit_timeout: float = 8.0,
    wait_timeout: float = 45.0,
    turn_retries: int = 3,
    now: Callable[[], float] = time.monotonic,
) -> Tuple[List[Outcome], float, Dict[str, List[List[int]]]]:
    """Drive a `multi_turn_trace` through a RequestRouter's client
    verbs: sessions run concurrently (open-loop starts), but WITHIN a
    session turn N+1 submits only after turn N completes — its prompt
    is the accumulated history (prior prompts + completions) plus the
    arrival's seeded suffix, shipped as an inline prompt-file payload
    with the turn's budget directive. Every turn streams; TTFT is the
    client-observed first streamed chunk.

    A failed turn retries up to ``turn_retries`` times (greedy decode
    is deterministic, so a retry cannot fork the transcript — the
    failover case leans on this); a turn that never completes aborts
    its session, with the remaining turns recorded as rejections so
    terminals stay exhaustive. Returns (outcomes, wall seconds,
    {session: completion token lists in turn order}) — the transcript
    map is what the bench's warm-vs-cold equality verdict compares."""
    from .router import RequestRejected

    t0 = now()
    outcomes: List[Outcome] = []
    transcripts: Dict[str, List[List[int]]] = {}
    by_session: Dict[str, List[Arrival]] = {}
    for a in trace.arrivals:
        if not a.session or a.turn <= 0:
            raise ValueError("run_sessions wants multi_turn_trace arrivals")
        by_session.setdefault(a.session, []).append(a)

    async def one_turn(
        a: Arrival, history: List[int]
    ) -> Tuple[Outcome, Optional[List[int]]]:
        prompt = history + list(a.suffix or ())
        budget = int(a.budget) or 16
        payload = (
            f"# max_new_tokens: {budget}\n"
            + " ".join(str(t) for t in prompt)
        )
        t_sub = now()
        try:
            rid = await ingress.submit(
                a.model, slo=a.slo, payload=payload, session=a.session,
                stream=True, timeout=submit_timeout,
            )
        except RequestRejected as e:
            return Outcome(
                slo=a.slo,
                terminal=TERMINAL_SHED if e.shed else TERMINAL_REJECTED,
                reason=e.reason, model=a.model, session=a.session,
                turn=a.turn,
            ), None
        except Exception as e:
            return Outcome(
                slo=a.slo, terminal=TERMINAL_LOST, reason=repr(e),
                model=a.model, session=a.session, turn=a.turn,
            ), None
        ttft_box: List[float] = []
        chunk_ts: List[float] = []
        stream_task = asyncio.ensure_future(ingress.stream_text(
            rid, timeout=wait_timeout,
            on_first=lambda: ttft_box.append(now() - t_sub),
            on_chunk=lambda _c: chunk_ts.append(now()),
        ))
        try:
            term = await ingress.wait(rid, timeout=wait_timeout)
        except Exception as e:
            stream_task.cancel()
            return Outcome(
                slo=a.slo, terminal=TERMINAL_LOST, reason=f"wait: {e!r}",
                model=a.model, session=a.session, turn=a.turn,
            ), None
        try:
            await stream_task  # EOF rides the terminal settle
        except Exception as e:
            # TTFT may be missing; the terminal is authoritative
            logging.getLogger(__name__).debug(
                "session stream drain ended early: %r", e
            )
        e2e = now() - t_sub
        result = term.get("result") if term.get("ok") else None
        toks = (result or {}).get("tokens")
        if term.get("ok") and isinstance(toks, list):
            return Outcome(
                slo=a.slo, terminal=TERMINAL_COMPLETED, e2e_s=e2e,
                deadline_met=bool(term.get("deadline_met")),
                model=a.model, session=a.session,
                worker=term.get("worker"), has_result=True,
                trace_id=term.get("trace_id"), turn=a.turn,
                ttft_s=ttft_box[0] if ttft_box else None,
                tpot_s=(
                    (chunk_ts[-1] - chunk_ts[0]) / (len(chunk_ts) - 1)
                    if len(chunk_ts) >= 2 else None
                ),
            ), [int(t) for t in toks]
        return Outcome(
            slo=a.slo,
            terminal=(TERMINAL_LOST if term.get("terminal") == "lost"
                      else TERMINAL_REJECTED),
            reason=term.get("reason") or "no_tokens_in_result",
            model=a.model, session=a.session, turn=a.turn,
        ), None

    async def one_session(sess: str, turns_list: List[Arrival]) -> None:
        history: List[int] = []
        transcripts[sess] = []
        for i, a in enumerate(sorted(turns_list, key=lambda x: x.turn)):
            delay = a.t - (now() - t0)
            if delay > 0:
                await asyncio.sleep(delay)
            o: Optional[Outcome] = None
            toks: Optional[List[int]] = None
            for attempt in range(turn_retries + 1):
                o, toks = await one_turn(a, history)
                if o.terminal == TERMINAL_COMPLETED or attempt == turn_retries:
                    break
                await asyncio.sleep(0.25 * (attempt + 1))
            assert o is not None
            outcomes.append(o)
            if o.terminal != TERMINAL_COMPLETED or toks is None:
                # the chain is broken — later prompts would diverge
                # from the deterministic transcript, so the session
                # aborts and its remaining turns settle as typed
                # rejections (terminals stay exhaustive for scoring)
                for rest in sorted(turns_list, key=lambda x: x.turn)[i + 1:]:
                    outcomes.append(Outcome(
                        slo=rest.slo, terminal=TERMINAL_REJECTED,
                        reason="session_aborted", model=rest.model,
                        session=sess, turn=rest.turn,
                    ))
                return
            # history grows by this turn's prompt suffix + completion
            transcripts[sess].append(toks)
            history = history + list(a.suffix or ()) + toks

    await asyncio.gather(
        *(one_session(s, rows) for s, rows in by_session.items())
    )
    return outcomes, now() - t0, transcripts


async def run_open_loop(
    submit: Callable[[Arrival], Awaitable[Outcome]],
    trace: ArrivalTrace,
    *,
    now: Callable[[], float] = time.monotonic,
) -> Tuple[List[Outcome], float]:
    """Drive the trace open-loop: each arrival fires at its scheduled
    offset from the run start whether or not earlier requests came
    back (that is the whole point). ``submit`` handles one request
    end-to-end and must ALWAYS return a terminal ``Outcome`` — the
    front door's typed-rejection contract means it never has to guess.
    Returns (outcomes in arrival order, wall seconds to last terminal).
    """
    t0 = now()
    results: List[Optional[Outcome]] = [None] * len(trace.arrivals)

    async def one(i: int, a: Arrival) -> None:
        delay = a.t - (now() - t0)
        if delay > 0:
            await asyncio.sleep(delay)
        results[i] = await submit(a)

    await asyncio.gather(
        *(one(i, a) for i, a in enumerate(trace.arrivals))
    )
    wall = now() - t0
    return [o for o in results if o is not None], wall
