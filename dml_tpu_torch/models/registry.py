"""Model registry: the families this package has ported.

Counterpart of dml_tpu/models/registry.py, with the same names, aliases,
input sizes, preprocess modes, cost priors and `spatial_invariant`
flags: ResNet50/101/152, InceptionV3, EfficientNetB0/B4, MobileNetV2 and
ViT-B16/S16/Ti16, every family of the JAX registry. Any other name
raises a KeyError that lists what is registered. The ViTs are built
with `attention=ops.flash_attention.flash_attention` (see models/vit.py).
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
    # True when param shapes are independent of the input's spatial size
    # (fully-conv + global-pool CNNs). ViT's pos_embed is sized by patch
    # count, so False there.
    spatial_invariant: bool = True

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


def _build_efficientnet(variant, num_classes=1000, dtype=torch.bfloat16, param_dtype=None):
    from .efficientnet import build_variant

    return build_variant(variant, num_classes=num_classes, dtype=dtype, param_dtype=param_dtype)


def _build_mobilenet(num_classes=1000, dtype=torch.bfloat16, param_dtype=None):
    from .mobilenet import MobileNetV2

    return MobileNetV2(num_classes=num_classes, dtype=dtype, param_dtype=param_dtype)


def _build_vit(variant, num_classes=1000, dtype=torch.bfloat16, param_dtype=None):
    from ..ops.flash_attention import flash_attention
    from . import vit

    return getattr(vit, f"ViT_{variant}")(num_classes=num_classes, dtype=dtype,
                                          param_dtype=param_dtype, attention=flash_attention)


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
    # input sizes inlined (efficientnet.VARIANTS), as the JAX registry does
    for variant, size in (("b0", 224), ("b4", 380)):
        register(
            ModelSpec(
                name=f"EfficientNet{variant.upper()}",
                builder=partial(_build_efficientnet, variant),
                input_size=(size, size),
                preprocess="raw",  # normalization baked into the graph
                # priors scaled from the ResNet CPU numbers by FLOPs
                cost=CostDefaults(load_time=4.0, first_query=1.5, per_query=0.3),
                aliases=(f"efficientnet-{variant}", f"effnet{variant}"),
            )
        )
    register(
        ModelSpec(
            name="MobileNetV2",
            builder=_build_mobilenet,
            input_size=(224, 224),
            preprocess="tf",  # keras mobilenet_v2 preprocess = [-1, 1]
            # light model: priors scaled well under the ResNet numbers
            cost=CostDefaults(load_time=2.0, first_query=0.5, per_query=0.08),
            aliases=("mobilenet", "mobilenet-v2", "mobilenetv2"),
        )
    )
    for variant in ("B16", "S16", "Ti16"):
        register(
            ModelSpec(
                name=f"ViT-{variant}",
                builder=partial(_build_vit, variant),
                input_size=(224, 224),
                preprocess="tf",  # [-1, 1] scaling, the standard ViT input
                cost=CostDefaults(load_time=4.0, first_query=1.5, per_query=0.3),
                aliases=(f"vit{variant.lower()}", f"vit_{variant.lower()}"),
                spatial_invariant=False,  # pos_embed sized by patch count
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
