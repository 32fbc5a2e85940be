"""Inference: the image engine (batched forward passes on the GPU) and
LM serving (`generate`: prefill, KV-cache decode; `quantize`: int8
weights; `lm_server`, `lm_backend`: continuous batching; `lm_sharded`:
the tp and pp serving forms, the KV slab codec and the worker groups'
LM backends: `sharded_lm_group_backend`, `DisaggLMBackend`,
`wire_lm_group`). As in the JAX package, only the image engine is
exported here."""

from .engine import InferenceEngine, InferenceResult  # noqa: F401
