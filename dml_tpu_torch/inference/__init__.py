"""Inference: the image engine (batched forward passes on the GPU) and
LM serving (`generate`: prefill, KV-cache decode; `quantize`: int8
weights; `lm_server`, `lm_backend`: continuous batching; `lm_sharded`:
the tp and pp serving forms and the KV slab codec)."""

from .engine import InferenceEngine, InferenceResult  # noqa: F401
