"""Model registry: the families this package has ported.

Counterpart of dml_tpu/models/registry.py, with the same names, input
sizes, preprocess modes and cost priors. Only the ported families are
registered (ResNet50/101/152, InceptionV3); any other name raises a
KeyError that lists what is registered.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn


@dataclass(frozen=True)
class CostDefaults:
    """Seed values for the scheduler's analytical cost model (reference
    ModelParameters, models.py:128-139; constants worker.py:57-89).
    These are priors: the engine re-measures on the device at warmup."""

    load_time: float
    first_query: float
    per_query: float
    download_time: float = 0.05
    default_batch_size: int = 32


@dataclass(frozen=True)
class ModelSpec:
    name: str
    builder: Callable[..., nn.Module]  # (num_classes, dtype, param_dtype) -> nn.Module
    input_size: Tuple[int, int]
    preprocess: str  # normalize mode
    cost: CostDefaults
    aliases: Tuple[str, ...] = ()

    def build(self, dtype: torch.dtype = torch.bfloat16, num_classes: int = 1000,
              param_dtype: Optional[torch.dtype] = None) -> nn.Module:
        """The model computing in `dtype`, its conv weights held in
        `param_dtype` (None: `dtype`, as the inference engine holds them;
        the trainer passes float32)."""
        kw = {} if param_dtype is None else {"param_dtype": param_dtype}
        return self.builder(num_classes=num_classes, dtype=dtype, **kw)


MODEL_REGISTRY: Dict[str, ModelSpec] = {}


def register(spec: ModelSpec) -> ModelSpec:
    MODEL_REGISTRY[spec.name.lower()] = spec
    for a in spec.aliases:
        MODEL_REGISTRY[a.lower()] = spec
    return spec


def get_model(name: str) -> ModelSpec:
    try:
        return MODEL_REGISTRY[name.lower()]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; registered: {sorted(set(s.name for s in MODEL_REGISTRY.values()))}"
        ) from None


def _build_resnet(depth, num_classes=1000, dtype=torch.bfloat16, param_dtype=None):
    from . import resnet

    return getattr(resnet, f"ResNet{depth}")(num_classes=num_classes, dtype=dtype,
                                              param_dtype=param_dtype)


def _build_inception(num_classes=1000, dtype=torch.bfloat16, param_dtype=None):
    from .inception import InceptionV3

    return InceptionV3(num_classes=num_classes, dtype=dtype, param_dtype=param_dtype)


def _register_builtin() -> None:
    register(
        ModelSpec(
            name="ResNet50",
            builder=partial(_build_resnet, 50),
            input_size=(224, 224),
            preprocess="caffe",
            # reference CPU priors: load 3.5s / first 1s / per-image 0.25s
            # (worker.py:74); the engine re-measures on the device
            cost=CostDefaults(load_time=3.5, first_query=1.0, per_query=0.25),
            aliases=("resnet", "resnet-50"),
        )
    )
    for depth, per_q in ((101, 0.48), (152, 0.70)):
        register(
            ModelSpec(
                name=f"ResNet{depth}",
                builder=partial(_build_resnet, depth),
                input_size=(224, 224),
                preprocess="caffe",
                # priors scaled from the ResNet50 CPU numbers by FLOPs
                cost=CostDefaults(load_time=4.0, first_query=1.2, per_query=per_q),
                aliases=(f"resnet-{depth}",),
            )
        )
    register(
        ModelSpec(
            name="InceptionV3",
            builder=_build_inception,
            input_size=(299, 299),
            preprocess="tf",
            # reference CPU priors: 5.6s / 2s / 0.325s (worker.py:61)
            cost=CostDefaults(load_time=5.6, first_query=2.0, per_query=0.325),
            aliases=("inception", "inception-v3"),
        )
    )


_register_builtin()
