"""Dtype policy: float32 parameters, bf16 (or float32) compute, float32 logits.

Counterpart of ``mdhs_tpu/core/dtypes.py``: ``training.precision`` names the
compute dtype ("bf16" by default; "f32" / "fp32" / "float32" for float32),
an unknown name the default policy, as in JAX.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32  # logits / losses

    @classmethod
    def from_config(cls, cfg) -> "DTypePolicy":
        name = "bf16"
        if cfg is not None:
            name = cfg.get("training.precision", "bf16") or "bf16"
        return POLICIES.get(str(name).lower(), DTypePolicy())


POLICIES = {
    "bf16": DTypePolicy(),
    "bfloat16": DTypePolicy(),
    "f32": DTypePolicy(compute_dtype=torch.float32),
    "fp32": DTypePolicy(compute_dtype=torch.float32),
    "float32": DTypePolicy(compute_dtype=torch.float32),
}
