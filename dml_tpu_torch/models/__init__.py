"""Model zoo: PyTorch definitions of the ported model families, with
the JAX package's Keras-compatible layer names."""

from .registry import MODEL_REGISTRY, ModelSpec, get_model  # noqa: F401
