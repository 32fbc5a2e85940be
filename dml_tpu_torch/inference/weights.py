"""Model-weight distribution through the replicated store.

The reference's workers each (re)download pretrained Keras weights at
model construction (models.py:26, 51). Here weights move like any
other replicated file: publish once (PUT, 4-way replicated, versioned
— rollback is "load version N-1"), and every worker fetches from a
nearby replica and loads it onto its device.

The file is the JAX package's: flax's msgpack of the `{'params',
'batch_stats'}` tree in flax layout (`params_io.variables_to_bytes`,
`to_flax_variables`), so a port node serves weights a JAX node
published, and the reverse.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..cluster.store_service import StoreService
from ..models.params_io import (
    to_flax_variables,
    variables_from_bytes,
    variables_to_bytes,
)
from ..models.registry import get_model


def weights_name(model_name: str) -> str:
    return f"weights_{get_model(model_name).name}.msgpack"


async def publish_weights(
    store: StoreService, model_name: str, variables: Dict[str, Any]
) -> Dict[str, Any]:
    """Serialize + PUT a model's variables (a flax-layout tree, e.g.
    `to_flax_variables(state_dict, module)`); returns the PUT reply
    (version + replica set)."""
    return await store.put_bytes(
        weights_name(model_name), variables_to_bytes(variables)
    )


async def fetch_weights(
    store: StoreService,
    model_name: str,
    version: Optional[int] = None,
    dtype: Optional[torch.dtype] = None,
) -> Dict[str, Any]:
    """GET a model's published weights (latest or pinned version) and
    read them against a flax-layout template of the model (its keys
    only: `to_flax_variables` of a freshly built module's state, built
    at the model's own input size, which ViT's `pos_embed` depends on): a
    nested dict of CPU tensors, in the stored dtypes or cast to `dtype`.
    `InferenceEngine.load_model` takes it as is."""
    spec = get_model(model_name)
    data = await store.get_bytes(weights_name(model_name), version=version)
    module = spec.build(dtype=torch.float32)
    like = to_flax_variables(module.state_dict(), module)
    restored = variables_from_bytes(data, like)
    if dtype is not None:
        restored = _cast(restored, dtype)
    return restored


def _cast(tree: Any, dtype: torch.dtype) -> Any:
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if isinstance(tree, torch.Tensor) else tree
