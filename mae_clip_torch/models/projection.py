"""ProjectionHead: Linear -> GELU -> Linear -> Dropout -> +residual -> LayerNorm
(``mae_clip_tpu/models/projection.py``; reference modules.py:55-76).

The residual comes from the first linear's output (``projected``), the GELU
is always the erf form, and the LayerNorm eps is 1e-5.
"""

from __future__ import annotations

import torch
from torch import nn

from mae_clip_torch.models.layers import Dense, LayerNorm, gelu


class ProjectionHead(nn.Module):
    def __init__(self, in_dim: int, projection_dim: int = 256,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.projection = Dense(in_dim, projection_dim, dtype)
        self.fc = Dense(projection_dim, projection_dim, dtype)
        self.dropout = nn.Dropout(dropout)
        self.layer_norm = LayerNorm(projection_dim, 1e-5, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        projected = self.projection(x)
        y = self.dropout(self.fc(gelu(projected, "erf")))
        return self.layer_norm(y + projected)
