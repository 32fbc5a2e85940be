"""Request front door: SLO-aware per-request ingress for the cluster.

- ``router``: RequestRouter — admission, continuous batch formation,
  session affinity, terminal-exactly-once delivery (the leader-side
  role + the client verbs).
- ``slo``: SLO classes + the pure admission/shedding math.
- ``loadgen``: seeded open-loop arrival traces + tail-latency scoring.
- ``streaming``: per-request LM token streaming over the data plane.
"""

from .loadgen import (  # noqa: F401
    Arrival, ArrivalTrace, Outcome, drive_one, open_loop_trace,
    percentile, run_open_loop, summarize,
)
from .router import BatchFormer, RequestRejected, RequestRouter  # noqa: F401
from .slo import DEFAULT_CLASSES, SLOClass, resolve_class, shed_reason  # noqa: F401
from .streaming import STUB_LM_MODEL, streaming_lm_stub  # noqa: F401
