"""A follower rank for the group-world tests, run as a script: the port's
counterpart of the JAX test model TinyNet (`tests/_tinynet.py`, as
`test_torch_train.py` defines it) in this process's model registry, then
the operator's entry point with the script's arguments (`node --spec S
--name H3 --follow 1 ...`). The primary builds its group engines by
registry name on every rank, so the follower needs the test model too."""

import sys

import torch
import torch.nn.functional as F
from torch import nn

from dml_tpu_torch.models.layers import BatchNorm, Conv2d
from dml_tpu_torch.models.registry import MODEL_REGISTRY, CostDefaults, ModelSpec, register


class TinyNet(nn.Module):
    """tests/_tinynet.py's TinyNet in PyTorch (Flax's SAME pad of a
    stride-2 3x3 conv on an even input is (0, 1))."""

    def __init__(self, num_classes=1000, dtype=torch.float32, param_dtype=None):
        super().__init__()
        pd = dtype if param_dtype is None else param_dtype
        self.dtype = dtype
        self.c1 = Conv2d(3, 8, 3, stride=2, dtype=pd, compute_dtype=dtype)
        self.bn1 = BatchNorm(8, 1e-5, momentum=0.9)
        self.c2 = Conv2d(8, 16, 3, stride=2, dtype=pd, compute_dtype=dtype)
        self.predictions = nn.Linear(16, num_classes)

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.c1(F.pad(x, (0, 1, 0, 1)))))
        x = F.relu(self.c2(F.pad(x, (0, 1, 0, 1))))
        return torch.softmax(self.predictions(x.mean(dim=(2, 3)).float()), dim=-1)


def register_tinynet() -> None:
    if "tinynet" not in MODEL_REGISTRY:
        register(ModelSpec(name="TinyNet", builder=TinyNet, input_size=(32, 32),
                           preprocess="unit",
                           cost=CostDefaults(load_time=0.1, first_query=0.1, per_query=0.01,
                                             default_batch_size=4)))


if __name__ == "__main__":
    torch.set_num_threads(1)
    register_tinynet()
    from dml_tpu_torch.cli import main

    main(sys.argv[1:])
