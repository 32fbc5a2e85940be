"""Token streaming for per-request LM serving.

The front door streams LM tokens to the client AS THEY DECODE instead
of after the batch drains: the worker executing an ingress batch
exposes one byte-stream per streaming request on its TCP data plane
(store/data_plane.py ``expose_stream``), tells the client where to
pull (REQUEST_STREAM_READY over the control plane), and feeds tokens
into the stream from the backend's ``on_token`` callback. Bulk bytes
never ride UDP — the same discipline as store transfers and KV-slab
handoffs.

The backend contract mirrors ``on_dispatch`` (jobs/service.py
register_lm): a backend that declares an ``on_token`` parameter opts
in; the service calls it as ``on_token(local_path, text)`` from
whatever thread the backend decodes on (the service hops it back to
the loop). Backends without the parameter serve ingress batches
normally — streaming requests then simply get their tokens with the
final result, a degraded-but-correct mode.

``streaming_lm_stub`` is the deterministic backend the
chaos.LocalCluster ingress wiring registers: it "decodes" a fixed
token sequence per input with a per-token delay, exercising the full
wire path (expose -> ready push -> TCP pull -> EOF) in tests and the
request_serving bench without a device.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

#: model name the stub registers under (LocalCluster ingress wiring)
STUB_LM_MODEL = "StubLM"


def streaming_lm_stub(
    per_token_s: float = 0.002, n_tokens: int = 6
) -> Callable:
    """Deterministic streaming LM stub: every input file 'decodes'
    ``n_tokens`` tokens at ``per_token_s`` each, firing ``on_token``
    per token; the final result per file is the full text — so a
    client can assert the streamed tokens concatenate to exactly the
    completed result."""

    async def backend(
        model: str, paths: List[str], on_token: Optional[Callable] = None
    ) -> Tuple[Dict[str, Any], float, None]:
        t0 = time.monotonic()
        results: Dict[str, Any] = {}
        for p in paths:
            parts = []
            for i in range(n_tokens):
                await asyncio.sleep(per_token_s)
                tok = f"tok{i} "
                parts.append(tok)
                if on_token is not None:
                    on_token(p, tok)
            results[p] = {"text": "".join(parts).strip()}
        return results, time.monotonic() - t0, None

    return backend
