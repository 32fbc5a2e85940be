"""Asyncio UDP transport for the control plane.

Replaces the reference's AwesomeProtocol/UdpTransport (protocol.py:13-81,
transport.py:26-34). Same responsibilities, same testing seams:

- inbound datagrams are decoded and queued; consumers `await recv()`
- `send()` supports deterministic synthetic packet loss for fault
  injection (reference protocol.py:10, 25-29: 3% drop via a
  pre-shuffled 100-slot bitmap) and bytes/bps accounting
  (reference protocol.py:72-74)

Unlike the reference we decode frames at the transport boundary and
hand typed `Message`s to the dispatcher, and loss injection is seeded
so multi-node simulations are reproducible.
"""

from __future__ import annotations

import asyncio
import random
import time
from typing import Callable, Optional, Tuple

from ..observability import METRICS
from .wire import Message

# control-plane traffic accounting, labeled by message type (the
# registry form of the reference's CLI option 9 byte counter)
_M_SENT = METRICS.counter(
    "transport_packets_sent_total", "datagrams sent, by message type")
_M_SENT_BYTES = METRICS.counter(
    "transport_bytes_sent_total", "payload bytes sent, by message type")
_M_DROPPED = METRICS.counter(
    "transport_packets_dropped_total",
    "outbound datagrams dropped by loss injection / partition filter")
_M_RECV = METRICS.counter(
    "transport_packets_received_total",
    "well-formed datagrams received, by message type")
_M_RECV_BYTES = METRICS.counter(
    "transport_bytes_received_total", "bytes received, by message type")
_M_DUPED = METRICS.counter(
    "transport_packets_duplicated_total",
    "extra datagram copies emitted by the duplication injector")
_M_DELAYED = METRICS.counter(
    "transport_packets_delayed_total",
    "outbound datagrams held back by the delay/reorder injector")
_M_DROPPED_IN = METRICS.counter(
    "transport_packets_dropped_inbound_total",
    "inbound datagrams dropped by the directional partition filter")
_M_MALFORMED = METRICS.counter(
    "transport_malformed_dropped_total",
    "inbound datagrams Message.unpack rejected (truncated, bit-flipped, "
    "bad magic/length, non-JSON, oversized — the byzantine-wire drop)")
# pre-touch so the counters are visible (as 0) in `profile metrics`
# and bench metrics blocks even before the first adversarial datagram
# — the fuzz/corruption scenarios must be observable, not silent
_M_MALFORMED.inc(0)
_M_DROPPED_IN.inc(0)


class LossInjector:
    """Deterministic packet-drop schedule (reference protocol.py:25-29).

    A pre-shuffled slot bitmap with a `pct` fraction of drop slots,
    cycled on every send — the reference's exact scheme (100 slots,
    protocol.py:25-29) but seedable and at 0.01% resolution so
    sub-1% rates don't silently round to zero.
    """

    SLOTS = 10_000

    def __init__(self, pct: float, seed: int = 0):
        if pct < 0 or pct > 100:
            raise ValueError(f"drop pct {pct} out of range")
        self.pct = pct
        n_drop = int(round(pct * self.SLOTS / 100))
        if pct > 0 and n_drop == 0:
            raise ValueError(f"drop pct {pct} below {100 / self.SLOTS}% resolution")
        slots = [True] * n_drop + [False] * (self.SLOTS - n_drop)
        random.Random(seed).shuffle(slots)
        self._slots = slots
        self._i = 0
        # fault-injection switch: tests can phase loss in (e.g. seed
        # the store losslessly, then stress the job pipeline)
        self.enabled = True

    def should_drop(self) -> bool:
        if not self.enabled or not self._slots or self.pct <= 0:
            return False
        drop = self._slots[self._i]
        self._i = (self._i + 1) % len(self._slots)
        return drop


class LinkShaper:
    """Seeded transport-level fault model: per-datagram delay,
    duplication, and reordering, composable with the drop/partition
    seams that already live on the transport.

    The chaos engine sets one shaper per node transport; every
    decision comes from a private ``random.Random(seed)``, so a plan
    re-run with the same seed makes the identical per-send choices
    (the *schedule* of injected faults is deterministic; actual
    arrival interleaving still rides the event loop, like a real
    network).

    - ``delay_s``/``jitter_s``: every datagram is held back by
      ``delay_s + U[0, jitter_s)`` before hitting the socket.
    - ``dup_pct``: percent of datagrams emitted twice (the second
      copy lands after ``reorder_extra_s`` so the duplicate is also a
      straggler, the worst case for idempotency).
    - ``reorder_pct``: percent of datagrams additionally held for
      ``reorder_extra_s``, so later sends overtake them —
      reordering without modeling a full queue.
    """

    def __init__(
        self,
        seed: int = 0,
        delay_s: float = 0.0,
        jitter_s: float = 0.0,
        dup_pct: float = 0.0,
        reorder_pct: float = 0.0,
        reorder_extra_s: float = 0.05,
        match: Optional[Callable[[Tuple[str, int]], bool]] = None,
    ):
        for name, pct in (("dup_pct", dup_pct), ("reorder_pct", reorder_pct)):
            if pct < 0 or pct > 100:
                raise ValueError(f"{name} {pct} out of range")
        if delay_s < 0 or jitter_s < 0 or reorder_extra_s < 0:
            raise ValueError("delays must be >= 0")
        self.delay_s = delay_s
        self.jitter_s = jitter_s
        self.dup_pct = dup_pct
        self.reorder_pct = reorder_pct
        self.reorder_extra_s = reorder_extra_s
        #: optional per-link scope: shape only datagrams whose dest
        #: address matches (None = every link from this node)
        self.match = match
        self.enabled = True
        self._rng = random.Random(seed)

    def delays(self, addr: Tuple[str, int]) -> list:
        """Per-copy send delays for one datagram (one entry per copy;
        0.0 = send immediately). Consumes RNG state even for
        unmatched links so a plan's decision stream doesn't depend on
        which addresses happen to be dialed."""
        rng = self._rng
        delay = self.delay_s + (rng.uniform(0.0, self.jitter_s) if self.jitter_s else 0.0)
        reorder = rng.random() * 100.0 < self.reorder_pct
        dup = rng.random() * 100.0 < self.dup_pct
        if not self.enabled or (self.match is not None and not self.match(addr)):
            return [0.0]
        if reorder:
            delay += self.reorder_extra_s
        out = [delay]
        if dup:
            out.append(delay + self.reorder_extra_s)
        return out


class UdpTransport(asyncio.DatagramProtocol):
    """Bind a UDP socket; queue inbound Messages; count outbound bytes."""

    def __init__(self, testing: bool = False, drop_pct: float = 0.0, seed: int = 0):
        self.testing = testing
        self._loss = LossInjector(drop_pct if testing else 0.0, seed)
        self._queue: asyncio.Queue[Tuple[Message, Tuple[str, int]]] = asyncio.Queue()
        self._transport: Optional[asyncio.DatagramTransport] = None
        # accounting (reference protocol.py:72-74; CLI option 9).
        # Receive-side totals live PER TRANSPORT (not only in the
        # shared registry): an in-process scale sim runs every node
        # over one registry, so per-node ingress attribution — e.g.
        # the leader's METRICS_PULL fan-in bytes — needs these.
        self.bytes_sent = 0
        self.packets_sent = 0
        self.bytes_received = 0
        self.packets_received = 0
        self.packets_dropped = 0
        self.first_send_time: Optional[float] = None
        # fault-injection seam: network-partition simulation. When
        # set, outbound datagrams to addresses the predicate matches
        # are dropped (set symmetrically on every node for a full
        # bidirectional partition).
        self.partition_filter: Optional[Callable[[Tuple[str, int]], bool]] = None
        # fault-injection seam: DIRECTIONAL partition — inbound
        # datagrams whose source address matches are dropped before
        # decode. With only the outbound filter, "A hears B but B
        # doesn't hear A" is unrepresentable: one-way link loss needs
        # a seam at the receiving ear, not just the sending mouth.
        self.inbound_filter: Optional[Callable[[Tuple[str, int]], bool]] = None
        self.packets_dropped_inbound = 0
        self.malformed_dropped = 0
        # fault-injection seam: per-link delay/duplication/reordering
        # (the chaos engine installs one; None = clean link)
        self.shaper: Optional[LinkShaper] = None

    def set_loss_enabled(self, enabled: bool) -> None:
        self._loss.enabled = enabled

    def set_loss(self, pct: float, seed: int = 0) -> None:
        """Swap the loss schedule at runtime (chaos loss ramps). The
        fresh injector starts at slot 0, so the drop pattern for a
        given (pct, seed) is reproducible no matter when the ramp
        fires."""
        self._loss = LossInjector(pct, seed)

    # -- DatagramProtocol callbacks --

    def connection_made(self, transport) -> None:  # pragma: no cover - asyncio
        self._transport = transport

    def datagram_received(self, data: bytes, addr: Tuple[str, int]) -> None:
        if self.inbound_filter is not None and self.inbound_filter(addr):
            self.packets_dropped_inbound += 1
            _M_DROPPED_IN.inc()
            return
        msg = Message.unpack(data)
        if msg is None:
            # byzantine wire input: anything unpack rejects dies HERE,
            # counted — never reaches a dispatcher coroutine
            self.malformed_dropped += 1
            _M_MALFORMED.inc()
            return
        self.bytes_received += len(data)
        self.packets_received += 1
        _M_RECV.inc(1, type=msg.type.name)
        _M_RECV_BYTES.inc(len(data), type=msg.type.name)
        self._queue.put_nowait((msg, addr))

    def error_received(self, exc) -> None:  # pragma: no cover - asyncio
        pass

    # -- public API --

    @classmethod
    async def bind(
        cls,
        host: str,
        port: int,
        testing: bool = False,
        drop_pct: float = 0.0,
        seed: int = 0,
        reuse_port: bool = False,
    ) -> "UdpTransport":
        # reuse_port defaults OFF: with it on, a port collision (e.g. a
        # leftover process) silently splits inbound traffic between the
        # two sockets instead of failing loudly with EADDRINUSE.
        loop = asyncio.get_running_loop()
        proto = cls(testing=testing, drop_pct=drop_pct, seed=seed)
        await loop.create_datagram_endpoint(
            lambda: proto, local_addr=(host, port), reuse_port=reuse_port or None
        )
        return proto

    def send(self, msg: Message, addr: Tuple[str, int]) -> None:
        """Fire-and-forget datagram (at-most-once; reliability comes
        from the periodic re-ping/re-send loops, like the reference)."""
        if self._transport is None:
            raise RuntimeError("transport not bound")
        if self.partition_filter is not None and self.partition_filter(addr):
            self.packets_dropped += 1
            _M_DROPPED.inc()
            return
        if self._loss.should_drop():
            self.packets_dropped += 1
            _M_DROPPED.inc()
            return
        frame = msg.pack()
        if self.first_send_time is None:
            self.first_send_time = time.monotonic()
        self.bytes_sent += len(frame)
        self.packets_sent += 1
        _M_SENT.inc(1, type=msg.type.name)
        _M_SENT_BYTES.inc(len(frame), type=msg.type.name)
        shaper = self.shaper
        if shaper is None:
            self._transport.sendto(frame, addr)
            return
        # shaped link: the shaper decides, per copy, how long each
        # datagram is held back (0.0 = the clean immediate path)
        for i, delay in enumerate(shaper.delays(addr)):
            if i:
                _M_DUPED.inc(1, type=msg.type.name)
            if delay <= 0.0:
                self._transport.sendto(frame, addr)
                continue
            _M_DELAYED.inc(1, type=msg.type.name)
            asyncio.get_running_loop().call_later(
                delay, self._sendto_if_open, frame, addr
            )

    def _sendto_if_open(self, frame: bytes, addr: Tuple[str, int]) -> None:
        """Deferred emit for shaped datagrams; a copy whose timer fires
        after close() is dropped on the floor (the node crashed — the
        network does the same)."""
        if self._transport is not None:
            self._transport.sendto(frame, addr)

    async def recv(self) -> Tuple[Message, Tuple[str, int]]:
        return await self._queue.get()

    def bps(self) -> float:
        """Observed send bandwidth (reference CLI option 9, worker.py:1724)."""
        if self.first_send_time is None:
            return 0.0
        dt = time.monotonic() - self.first_send_time
        return self.bytes_sent / dt if dt > 0 else 0.0

    def close(self) -> None:
        if self._transport is not None:
            # abort, not close: close() keeps the socket (and the
            # PORT) alive until asyncio drains any buffered sends —
            # an un-flushed buffer under load holds the bind for
            # seconds, and a node restarting with the same identity
            # then fails EADDRINUSE. This is at-most-once UDP: the
            # buffered tail datagrams are within the loss model.
            self._transport.abort()
            self._transport = None
