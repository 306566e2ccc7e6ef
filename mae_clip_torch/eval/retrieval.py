"""Embedding computation for retrieval (``mae_clip_tpu/eval/retrieval.py``).

The embed functions run under ``torch.inference_mode()`` on the model's
device and return fp32 embeddings (the model computes in its compute dtype).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from mae_clip_torch.data.images import normalize_uint8


def _image_embed_fn(model) -> Callable:
    """``embed(images) -> (B, projection_dim)`` for uint8 or normalised
    images, NHWC or pre-patchified."""
    @torch.inference_mode()
    def embed(images) -> torch.Tensor:
        x = normalize_uint8(torch.as_tensor(images).to(model.device))
        return model.project_image(model.encode_image(x)).float()

    return embed


def _text_embed_fn(model) -> Callable:
    """``embed(input_ids, attention_mask) -> (B, projection_dim)``."""
    @torch.inference_mode()
    def embed(ids, mask) -> torch.Tensor:
        ids = torch.as_tensor(ids).to(model.device)
        mask = torch.as_tensor(mask).to(model.device)
        return model.project_text(model.encode_text(ids, mask)).float()

    return embed


def compute_text_embeddings(model, input_ids, attention_mask,
                            batch_size: int) -> np.ndarray:
    """Chunked encode+project of an (N, S) token table into (N, proj_dim)."""
    embed = _text_embed_fn(model)
    chunks = [embed(input_ids[s:s + batch_size],
                    attention_mask[s:s + batch_size]).cpu().numpy()
              for s in range(0, len(input_ids), batch_size)]
    return np.concatenate(chunks)


def compute_image_embeddings(model, loader: Iterable[Dict],
                             max_batches: Optional[int] = None
                             ) -> torch.Tensor:
    """Encode + project every image batch into one (N, proj_dim) gallery on
    the model's device (reference inference.py:21-27). Rows whose
    ``batch["valid"]`` is False are dropped; ``max_batches`` stops early."""
    embed = _image_embed_fn(model)
    chunks: List[torch.Tensor] = []
    for bi, batch in enumerate(loader):
        if max_batches is not None and bi >= max_batches:
            break
        emb = embed(batch["image"])
        if "valid" in batch:
            valid = torch.as_tensor(np.asarray(batch["valid"], dtype=bool))
            emb = emb[valid.to(emb.device)]
        chunks.append(emb)
    return torch.cat(chunks, dim=0)
