"""Linear and LayerNorm with the JAX package's dtype semantics.

flax's ``nn.Dense(dtype=d)`` keeps float32 parameters and casts both the
input and the weights to ``d`` for the product; ``nn.LayerNorm(dtype=
float32)`` normalises in float32. These wrappers do the same, so one set of
float32 weights serves the float32 parity runs and the bf16 runs on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype``; weight is (out, in)."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        b = None if self.bias is None else self.bias.to(d)
        return F.linear(x.to(d), self.weight.to(d), b)


class LayerNorm(nn.LayerNorm):
    """float32 LayerNorm (eps 1e-6, the flax default) returning ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32, eps: float = 1e-6):
        super().__init__(dim, eps=eps)
        self.out_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.out_dtype)
