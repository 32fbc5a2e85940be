"""Small shared helpers for services built on the at-most-once UDP
control plane."""

from __future__ import annotations

import asyncio
import errno
import itertools
import logging
import random
import zlib
from typing import Any, Awaitable, Callable, Dict, Optional, TypeVar

from .wire import MsgType

log = logging.getLogger(__name__)

T = TypeVar("T")


async def rebind_retry(
    fn: Callable[[], Awaitable[T]], attempts: int = 10, delay: float = 0.2
) -> T:
    """Run a bind-ish coroutine factory, retrying briefly on
    EADDRINUSE: UdpTransport.close aborts its socket, but the kernel
    can take a few loop ticks to release the port, so a same-identity
    restart (node or introducer DNS) may race its previous
    incarnation. The one shared form of the retry — node restart and
    DNS restart must not drift apart."""
    for attempt in range(attempts):
        try:
            return await fn()
        except OSError as e:
            if e.errno != errno.EADDRINUSE or attempt == attempts - 1:
                raise
            await asyncio.sleep(delay)
    raise AssertionError("unreachable")


async def reap_task(task: Optional[asyncio.Task], who: Any, what: str) -> None:
    """Cancel-and-await one background task during teardown, logging
    anything other than the requested cancellation — the one shared
    form of the stop() reap (a blanket ``except (CancelledError,
    Exception): pass`` here used to hide real teardown bugs).

    The cancel is RE-ISSUED until the task actually ends: a single
    ``task.cancel()`` can be silently eaten by Python 3.10's
    ``asyncio.wait_for`` completion/cancellation race (bpo-42130 — if
    the inner future completes in the same tick the cancel arrives,
    wait_for returns the result and the CancelledError evaporates).
    A dispatch loop mid-data-plane-RPC hit exactly that under chaos
    crash timing, looped back to ``recv()`` un-cancelled, and the old
    single-shot reap awaited it forever — wedging every teardown
    above it. Each round gives the task a grace period to run its
    cleanup before the next cancel."""
    if task is None:
        return
    for attempt in range(30):
        task.cancel()
        try:
            await asyncio.wait_for(asyncio.shield(task), timeout=2.0)
            return  # completed with a result despite the cancel
        except asyncio.TimeoutError:
            if attempt:
                log.warning(
                    "%s: %s survived cancel x%d (swallowed "
                    "cancellation?); re-issuing", who, what, attempt + 1,
                )
            continue
        except asyncio.CancelledError:
            if not task.cancelled():
                # the reaped task did NOT end cancelled, so this
                # CancelledError was aimed at the CALLER (e.g. a
                # timeout around stop()) — it must propagate
                raise
            return
        except Exception:
            log.exception("%s: %s raised during stop", who, what)
            return
    log.error(
        "%s: %s would not die after %d cancels; abandoning it to the "
        "event loop's teardown", who, what, 30,
    )


#: distinguishes concurrent leader_retry calls in the default-jitter seed
_retry_nonce = itertools.count()


class BoundedDict(dict):
    """Dict that evicts its oldest insertion beyond `maxlen` — for
    idempotency-token and recently-completed caches that must not grow
    with a long-lived process.

    ``on_evict(key)`` fires per bound-forced eviction (NOT on explicit
    deletes): silent eviction is invisible state loss — e.g. a
    session-affinity row aging out of the router guarantees the
    session's next turn misses its worker's KV cache, which operators
    can only see if the eviction is counted."""

    def __init__(self, maxlen: int = 1000, on_evict=None):
        super().__init__()
        self.maxlen = maxlen
        self.on_evict = on_evict

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        while len(self) > self.maxlen:
            victim = next(iter(self))
            del self[victim]
            if self.on_evict is not None:
                try:
                    self.on_evict(victim)
                except Exception:
                    log.exception("BoundedDict on_evict hook failed")

    def setdefault(self, key, default=None):
        # dict.setdefault is C-level and bypasses __setitem__; route it
        # through so the bound holds for setdefault-populated caches
        if key not in self:
            self[key] = default
            return default
        return self[key]


async def leader_retry(
    node,
    mtype: MsgType,
    data: Dict[str, Any],
    timeout: float,
    retries: int = 3,
    rng: Optional[random.Random] = None,
) -> Dict[str, Any]:
    """node.leader_request with retry on timeout: a dropped request or
    reply datagram must not strand the caller. Callers ensure the
    operation is idempotent (reads naturally; writes via dedup
    tokens).

    Retries back off exponentially (capped at one try-slice) with
    deterministic jitter, so under loss the cluster's clients don't
    re-fire in lockstep and hammer the leader in synchronized waves.
    The default jitter stream is seeded from this node's identity,
    the message type, and a per-call nonce — decorrelated across
    nodes AND across concurrent calls on one node, reproducible given
    the same call order; pass `rng` to pin it exactly. The whole loop
    observes a hard deadline of `timeout` seconds: per-try waits and
    backoff sleeps shrink to fit, so the caller never waits longer
    than it asked for.
    """
    if rng is None:
        # per-call nonce: concurrent retries from ONE node for the
        # same message type must not replay the identical jitter
        # sequence and re-fire in synchronized bursts
        rng = random.Random(zlib.crc32(
            f"{node.me.unique_name}/{mtype.name}/"
            f"{next(_retry_nonce)}".encode()
        ))
    last: Optional[Exception] = None
    retries = max(1, retries)
    per_try = max(0.5, timeout / retries)
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    backoff = min(0.05, per_try / 8)
    attempt = 0
    while True:
        remaining = deadline - loop.time()
        if remaining <= 0:
            break
        if node.leader_node is None:
            # mid-failover: no leader to ask yet. Waiting here burns
            # deadline, not send attempts — firing requests into the
            # void would exhaust `retries` before the election ends.
            last = last or RuntimeError("no leader known")
            await asyncio.sleep(min(0.1, remaining))
            continue
        try:
            return await node.leader_request(
                mtype, data, timeout=min(per_try, remaining)
            )
        except asyncio.TimeoutError as e:
            last = e
        except RuntimeError as e:
            if "no leader" not in str(e):
                # only the leaderless window is retryable here; a
                # transport-not-bound / use-after-stop RuntimeError is
                # a real bug that must surface, not become a
                # misleading TimeoutError
                raise
            last = e  # leader vanished between the check and the send
        attempt += 1
        if attempt >= retries:
            break
        # capped exponential backoff, jittered over [0.5x, 1.5x)
        sleep = min(per_try, backoff * (2 ** attempt)) * (0.5 + rng.random())
        sleep = min(sleep, max(0.0, deadline - loop.time()))
        if sleep > 0:
            await asyncio.sleep(sleep)
    raise TimeoutError(f"{mtype.name} got no reply after {retries} tries") from last
