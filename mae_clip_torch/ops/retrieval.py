"""Retrieval: L2-normalise -> similarity matmul -> running top-k
(``mae_clip_tpu/ops/retrieval.py``; reference inference.py:42-47).

The gallery is scored in chunks of ``chunk_size`` rows, each merged into a
running top-k, so a large gallery never materialises a full (Q, N) score
matrix. The JAX package has no Pallas kernel here: the products go to
``torch.matmul`` and the selection to ``torch.topk``, in fp32.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize(p=2) semantics: x / max(||x||, eps)."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True),
                           min=eps)


def _chunked_topk(q: torch.Tensor, arrays: Tuple[torch.Tensor, ...], n: int,
                  k: int, chunk_size: int, score: Callable
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Running top-k over gallery chunks: ``arrays`` are (N, ...) gallery-side
    tensors cut together; ``score(*chunks) -> (Q, chunk)``."""
    if n <= chunk_size:
        return torch.topk(score(*arrays), k, dim=1)
    nq = q.shape[0]
    best_s = torch.full((nq, k), float("-inf"), device=q.device)
    best_i = torch.zeros((nq, k), dtype=torch.long, device=q.device)
    for start in range(0, n, chunk_size):
        s = score(*(a[start:start + chunk_size] for a in arrays))
        ids = torch.arange(start, start + s.shape[1], device=q.device)
        cand_i = torch.cat([best_i, ids.expand(nq, -1)], dim=1)
        best_s, pos = torch.topk(torch.cat([best_s, s], dim=1), k, dim=1)
        best_i = torch.gather(cand_i, 1, pos)
    return best_s, best_i


def retrieval_topk(queries: torch.Tensor, gallery: torch.Tensor, k: int,
                   chunk_size: int = 8192, normalize: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k gallery rows per query by cosine (or dot) similarity:
    (scores (Q, k), indices (Q, k)), sorted descending."""
    q, g = queries.float(), gallery.float()
    if normalize:
        q, g = l2_normalize(q), l2_normalize(g)
    return _chunked_topk(q, (g,), g.shape[0], k, chunk_size,
                         lambda chunk: q @ chunk.T)


def quantize_embeddings(emb: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantisation of (L2-normalised) rows:
    (q (N, D) int8, scales (N,) fp32), dequantised as q * scale."""
    x = emb.float()
    amax = x.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize_embeddings(q: torch.Tensor, scales: torch.Tensor,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return q.to(dtype) * scales[:, None].to(dtype)


def retrieval_topk_int8(queries: torch.Tensor, gallery_q: torch.Tensor,
                        scales: torch.Tensor, k: int,
                        chunk_size: int = 8192
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``retrieval_topk`` over an int8 gallery, dequantised chunk by chunk
    (only ``chunk_size`` fp32 rows exist at once). Queries are normalised;
    the gallery is assumed quantised from normalised rows."""
    q = l2_normalize(queries.float())

    def score(chunk_q, chunk_s):
        return q @ dequantize_embeddings(chunk_q, chunk_s).T

    return _chunked_topk(q, (gallery_q, scales), gallery_q.shape[0], k,
                         chunk_size, score)


def strided_dedup(indices: torch.Tensor, n: int, stride: int = 5
                  ) -> torch.Tensor:
    """Every ``stride``-th hit of the top n*stride (reference
    inference.py:46-47 ``indices[::5]``)."""
    return indices[..., ::stride][..., :n]
