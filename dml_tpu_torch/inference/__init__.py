"""Inference: the image engine (batched forward passes on the GPU) and
LM serving (`generate`: prefill, KV-cache decode; `quantize`: int8
weights)."""

from .engine import InferenceEngine, InferenceResult  # noqa: F401
