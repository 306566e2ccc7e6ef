"""MAE random masking (``mae_clip_tpu/ops/masking.py``).

The argsort-of-uniform-noise trick of the MAE paper: per sample, argsort N
noise values and keep the first ``int(N * (1 - mask_ratio))`` indices, so the
visible count is fixed. ``gather_patches`` is ``torch.take_along_dim``, which
is exact; the JAX package's one-hot matmul gather exists only for the TPU.
``scatter_with_mask_tokens`` puts the visible tokens and mask tokens back in
patch order for the MAE-paper (``'full'``) decoder.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mae_clip_torch.device import resolve_device


class MaskingResult(NamedTuple):
    ids_keep: torch.Tensor     # (B, len_keep) indices of visible patches
    ids_restore: torch.Tensor  # (B, N) inverse permutation
    mask: torch.Tensor         # (B, N) float; 1 = masked (to reconstruct)
    ids_masked: torch.Tensor   # (B, N - len_keep) indices of masked patches


def random_masking(batch: int, num_patches: int, mask_ratio: float,
                   generator: Optional[torch.Generator] = None,
                   device=None) -> MaskingResult:
    """Draw one masking per sample from ``generator``. The masks live on
    ``device``, by default the generator's device, else the card (which
    raises without one); a generator must live on ``device``."""
    if device is None:
        device = generator.device if generator is not None else "cuda"
    device = resolve_device(device)
    len_keep = int(num_patches * (1.0 - mask_ratio))
    noise = torch.rand(batch, num_patches, generator=generator, device=device)
    ids_shuffle = torch.argsort(noise, dim=1)
    ids_restore = torch.argsort(ids_shuffle, dim=1)
    mask = torch.ones(batch, num_patches, device=noise.device)
    mask[:, :len_keep] = 0.0
    mask = torch.gather(mask, 1, ids_restore)
    return MaskingResult(ids_shuffle[:, :len_keep], ids_restore, mask,
                         ids_shuffle[:, len_keep:])


def gather_patches(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather tokens along axis 1: (B, N, D), (B, K) -> (B, K, D)."""
    return torch.take_along_dim(x, ids[:, :, None], dim=1)


def scatter_with_mask_tokens(x_visible: torch.Tensor, mask_token: torch.Tensor,
                             ids_restore: torch.Tensor) -> torch.Tensor:
    """Append mask tokens to the visible tokens and un-shuffle to patch
    order: (B, K, D) visible (no CLS), (1, 1, D) token, (B, N) inverse
    permutation -> (B, N, D)."""
    b, k, d = x_visible.shape
    n = ids_restore.shape[1]
    mask_tokens = mask_token.expand(b, n - k, d).to(x_visible.dtype)
    x_full = torch.cat([x_visible, mask_tokens], dim=1)
    return torch.take_along_dim(x_full, ids_restore[:, :, None], dim=1)
