"""Leader election: a real bully election over the live membership.

Replaces the reference's Election (election.py:7-32) and its election
message loop (worker.py:1161-1179). The reference *intended* a bully
election but hardcoded the winner to node H2 (election.py:24-32 compares
against H2's unique_name); we implement the intent: the winner is the
highest-(rank, host, port) node among the currently-alive set
(`ClusterSpec.election_winner`).

Pure-logic state machine, no I/O: the node runtime drives it —
`tick()` tells the runtime which ELECTION messages to send each
failure-detector tick (reference send_election_messages,
worker.py:1161-1169), and the COORDINATE/COORDINATE_ACK exchange is
handled by the runtime's packet handlers calling `won()` / `resolved()`.

Flow (reference §3.5):
- membership cleanup detects the dead leader -> `start()`
  (membershipList.py:39-43 -> election.py:16-22)
- every tick while electing, gossip ELECTION to the ping targets;
  receivers not yet in the election join it (worker.py:621-629)
- each node checks whether IT is the winner among alive nodes; the
  winner multicasts COORDINATE (worker.py:1171-1179)
- everyone replies COORDINATE_ACK with its local file inventory; the
  new leader rebuilds store metadata from the ACKs and updates the
  introducer DNS (worker.py:631-649, 1150-1153)
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from ..config import ClusterSpec, NodeId


@dataclass
class Election:
    spec: ClusterSpec
    me: NodeId
    clock: Callable[[], float] = time.time

    in_progress: bool = False
    started_at: float = 0.0
    # set when a COORDINATE is accepted; cleared on start()
    last_winner: Optional[str] = field(default=None)

    def start(self) -> bool:
        """Enter the election phase (reference initiate_election,
        election.py:16-22). Returns True if newly started."""
        if self.in_progress:
            return False
        self.in_progress = True
        self.started_at = self.clock()
        self.last_winner = None
        return True

    def on_election_message(self) -> bool:
        """A peer says an election is on; join it (reference ELECTION
        handler, worker.py:621-629). Returns True if newly joined."""
        return self.start()

    def i_win(self, alive: List[NodeId]) -> bool:
        """Am I the bully winner among currently-alive nodes?
        (Reference check_if_leader, election.py:24-32 — hardcoded to
        H2 there; real comparison here.)"""
        if not self.in_progress:
            return False
        winner = self.spec.election_winner(alive)
        return winner is not None and winner.unique_name == self.me.unique_name

    def resolved(self, winner_unique_name: str) -> None:
        """A COORDINATE was accepted: the election is over (reference
        COORDINATE handler, worker.py:631-637)."""
        self.in_progress = False
        self.last_winner = winner_unique_name
