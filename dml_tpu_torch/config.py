"""Speculative-decoding settings: the port's copy of the part of
dml_tpu/config.py that `inference.lm_backend` reads (`:195-234`)."""

from __future__ import annotations

from typing import Any, Dict

#: break-even acceptance below which a server reverts to plain decode
#: (`lm_spec["spec_min_accept"]`): under ~1/3 acceptance a verify
#: round's expected commit (~rate*k + 1) no longer pays for the
#: verify forward and the draft's own steps
SPEC_MIN_ACCEPT_DEFAULT = 0.35

#: proposals measured before the acceptance gate may fire (and the
#: sliding window's grain after that)
SPEC_MIN_SAMPLES_DEFAULT = 64


def draft_lm_spec(lm_spec: Dict[str, Any], **overrides: Any) -> Dict[str, Any]:
    """A draft-model spec derived from a target `lm_spec`: the same
    vocab, dtype and heads, half the layers, half d_model (rounded up to
    a multiple of n_heads) and half d_ff, weights from `seed + 1`.
    Serving keys (max_slots, chunk, spec_*, kv_cache_mb, weights) are
    dropped; `overrides` pin any field."""
    heads = int(lm_spec.get("n_heads", 8))
    d_model = int(lm_spec["d_model"])
    d_half = max(heads, ((d_model // 2 + heads - 1) // heads) * heads)
    d_ff = int(lm_spec.get("d_ff", 4 * d_model))
    spec: Dict[str, Any] = {
        "name": f"{lm_spec.get('name', 'LM')}-draft",
        "vocab_size": int(lm_spec["vocab_size"]),
        "d_model": d_half,
        "n_heads": heads,
        "n_layers": max(1, int(lm_spec.get("n_layers", 2)) // 2),
        "d_ff": max(d_half, d_ff // 2),
        "dtype": lm_spec.get("dtype", "bfloat16"),
        "seed": int(lm_spec.get("seed", 0)) + 1,
    }
    if lm_spec.get("n_kv_heads") is not None:
        spec["n_kv_heads"] = int(lm_spec["n_kv_heads"])
    spec.update(overrides)
    return spec
