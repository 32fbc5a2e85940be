"""The introducer DNS: a tiny UDP rendezvous service.

Replaces the reference's `introduce process/` (~550 LoC standalone
program with its own copies of config/nodes/packets/protocol/transport;
handler at introduce process/worker.py:43-62) with ~60 lines sharing
the framework's transport and wire format.

Contract (identical to the reference):
- remembers the unique_name of the current introducer/leader
- FETCH_INTRODUCER -> FETCH_INTRODUCER_ACK {introducer}
- UPDATE_INTRODUCER {introducer} -> stores it, UPDATE_INTRODUCER_ACK
  (sent by a newly-elected leader, reference worker.py:1150-1153)

The initial introducer comes from the ClusterSpec instead of being
hardcoded in a second config file (reference
introduce process/config.py:96 + README STEP-1 duplication).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from ..config import ClusterSpec, NodeId
from .transport import UdpTransport
from .util import rebind_retry
from .wire import Message, MsgType

log = logging.getLogger(__name__)


class IntroducerService:
    """Single-purpose UDP key-value server for leader discovery."""

    def __init__(self, spec: ClusterSpec, initial_introducer: Optional[str] = None):
        if spec.introducer is None:
            raise ValueError("cluster spec has no introducer address")
        self.spec = spec
        self.me: NodeId = spec.introducer
        # default initial leader: the election winner over the full
        # static node table (the reference hardcodes its H1 equivalent)
        if initial_introducer is None:
            win = spec.election_winner(spec.nodes)
            initial_introducer = win.unique_name if win else ""
        self.current_introducer = initial_introducer
        self.transport: Optional[UdpTransport] = None
        self._task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        """Bind and serve. The bind rides the shared same-identity
        rebind retry (util.rebind_retry): a restarting DNS (chaos
        introducer-outage scenario, or a supervised process bouncing)
        can race its previous incarnation's socket release."""
        self.transport = await rebind_retry(
            lambda: UdpTransport.bind(self.me.host, self.me.port)
        )
        self._task = asyncio.create_task(self._serve(), name="introducer-serve")
        log.info("introducer DNS up at %s, introducer=%s",
                 self.me.unique_name, self.current_introducer)

    async def stop(self) -> None:
        # snapshot-before-await (dmllint race-yield-hazard): clear the
        # attribute before the join yields, so a concurrent
        # start()/stop() pair can't null a freshly-created serve task
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        if self.transport is not None:
            self.transport.close()
            self.transport = None

    async def _serve(self) -> None:
        assert self.transport is not None
        while True:
            msg, addr = await self.transport.recv()
            if msg.type == MsgType.FETCH_INTRODUCER:
                self.transport.send(
                    Message(
                        self.me.unique_name,
                        MsgType.FETCH_INTRODUCER_ACK,
                        {"rid": msg.data.get("rid"),
                         "introducer": self.current_introducer},
                    ),
                    addr,
                )
            elif msg.type == MsgType.UPDATE_INTRODUCER:
                # elastic membership: the leader's periodic re-assert
                # piggybacks the universe change log, so the DNS keeps
                # learning runtime-joined nodes (each entry verifies
                # its own HMAC stamp inside apply_universe — a forged
                # update can't teach the DNS a phantom). Without this,
                # a joined node promoted to leader could never pass
                # the node-table validation below.
                uni = msg.data.get("uni")
                if isinstance(uni, dict) and self.spec.join_secret:
                    self.spec.apply_universe(uni)
                new = msg.data.get("introducer", "")
                if new and self.spec.node_by_unique_name(new) is not None:
                    self.current_introducer = new
                    log.info("introducer updated -> %s", new)
                self.transport.send(
                    Message(self.me.unique_name, MsgType.UPDATE_INTRODUCER_ACK,
                            {"rid": msg.data.get("rid")}),
                    addr,
                )
