"""Image normalisation (the port's copy of the normalisation in
``mae_clip_tpu/data/images.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def normalize_uint8(images: torch.Tensor,
                    compute_dtype: Optional[torch.dtype] = None
                    ) -> torch.Tensor:
    """ImageNet normalisation of uint8 input, NHWC (B, H, W, C) or
    pre-patchified (B, N, P*P*C) with the channel minor in each patch
    vector. Non-uint8 input is returned unchanged."""
    if images.dtype != torch.uint8:
        return images
    out = normalize_pixels(images.to(torch.float32))
    return out if compute_dtype is None else out.to(compute_dtype)


def normalize_pixels(x: torch.Tensor) -> torch.Tensor:
    """ImageNet normalisation of float pixels on the 0..255 scale (the
    in-step crops), NHWC or pre-patchified as ``normalize_uint8``."""
    x = x / 255.0
    mean = torch.from_numpy(IMAGENET_MEAN).to(x.device)
    std = torch.from_numpy(IMAGENET_STD).to(x.device)
    if x.dim() == 3:
        reps = x.shape[-1] // 3
        mean, std = mean.repeat(reps), std.repeat(reps)
    return (x - mean) / std
