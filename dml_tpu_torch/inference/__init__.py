"""Inference engine: batched forward passes on the GPU."""

from .engine import InferenceEngine, InferenceResult  # noqa: F401
