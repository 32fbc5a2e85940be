"""AdamW as the JAX package's trainers run it, and its state by
parameter name.

`make_adamw` is `torch.optim.AdamW` with optax.adamw's hyperparameters
(b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on every parameter;
torch's AdamW defaults to 1e-2), fused on a CUDA device. Its update is
optax's: the same bias corrections from a count that starts at 0, eps
outside the square root, decay applied to the parameter before the
step. `adam_state` / `load_adam_state` read and write the optimizer's
moments as `{"count": int, "exp_avg": {name: tensor}, "exp_avg_sq":
{name: tensor}}`, the form the trainers' `state` and checkpoints carry
and that the converters from the JAX package's optax state produce.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Tuple

import torch

ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8
WEIGHT_DECAY = 1e-4  # optax.adamw's default

Named = List[Tuple[str, torch.nn.Parameter]]


def make_adamw(params: Iterable[torch.nn.Parameter], lr: float,
               device: torch.device) -> torch.optim.AdamW:
    return torch.optim.AdamW(
        params, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS, weight_decay=WEIGHT_DECAY,
        fused=True if device.type == "cuda" else None,
    )


def adam_count(optimizer: torch.optim.Optimizer, named: Named) -> int:
    """Updates the optimizer has made (0 before the first)."""
    first = optimizer.state.get(named[0][1])
    return int(first["step"]) if first else 0


def adam_state(optimizer: torch.optim.Optimizer, named: Named) -> Dict[str, Any]:
    """The moments by parameter name (zeros before the first update);
    the tensors are the live ones, not copies."""
    opt = optimizer.state

    def moment(key):
        return {n: opt[p][key] if p in opt else torch.zeros_like(p) for n, p in named}

    return {"count": adam_count(optimizer, named), "exp_avg": moment("exp_avg"),
            "exp_avg_sq": moment("exp_avg_sq")}


def load_adam_state(optimizer: torch.optim.Optimizer, named: Named,
                    opt_state: Mapping[str, Any]) -> None:
    """Set the optimizer's moments and count from `adam_state`'s form
    (copies: the optimizer keeps what it is given)."""

    def own(x, p):
        return x.to(device=p.device, dtype=p.dtype, copy=True)

    optimizer.load_state_dict({
        "state": {i: {"step": torch.tensor(float(opt_state["count"])),
                      "exp_avg": own(opt_state["exp_avg"][n], p),
                      "exp_avg_sq": own(opt_state["exp_avg_sq"][n], p)}
                  for i, (n, p) in enumerate(named)},
        "param_groups": optimizer.state_dict()["param_groups"],
    })
