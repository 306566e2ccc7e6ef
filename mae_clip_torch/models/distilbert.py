"""DistilBERT text encoder (``mae_clip_tpu/models/distilbert.py``).

HF ``DistilBertModel`` layout and math: learned positions added to word
embeddings, LayerNorm eps 1e-12, post-LN blocks, CLS pooling in
``TextEncoder``. Parameter names follow HF (``embeddings.word_embeddings``,
``transformer.layer.{i}.attention.q_lin``, ``ffn.lin1``, ...).

Attention goes through ``multi_head_attention`` with the padding mask; on the
card that is the flash CUDA kernel, which reads q/k/v as strided head views of
the linear outputs and writes its context in the layout ``out_lin`` reads, so
the head split and merge copy nothing. Its masked keys get ``-0.7 * f32max``
where HF writes ``finfo.min``: the softmax is the same whenever a row has a
valid key. In train mode with ``attention_dropout > 0`` (HF's default 0.1)
attention takes the plain route with dropout on the softmaxed weights
instead, as the JAX package sends that case to ``attention_xla``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from mae_clip_torch.models.layers import (Dense, Embed, LayerNorm, gelu,
                                          run_block)
from mae_clip_torch.ops.attention import multi_head_attention


@dataclasses.dataclass(frozen=True)
class DistilBertConfig:
    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 6
    n_heads: int = 12
    hidden_dim: int = 3072
    max_position_embeddings: int = 512
    dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    gelu: str = "erf"


class Embeddings(nn.Module):
    def __init__(self, config: DistilBertConfig, dtype: torch.dtype):
        super().__init__()
        c = config
        self.word_embeddings = Embed(c.vocab_size, c.dim, dtype)
        self.position_embeddings = Embed(c.max_position_embeddings, c.dim,
                                         dtype)
        self.LayerNorm = LayerNorm(c.dim, c.layer_norm_eps, dtype)
        self.dropout = nn.Dropout(c.dropout)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(input_ids.shape[-1], device=input_ids.device)
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)[None]
        return self.dropout(self.LayerNorm(x))


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, config: DistilBertConfig, dtype: torch.dtype):
        super().__init__()
        c = self.config = config
        self.q_lin = Dense(c.dim, c.dim, dtype)
        self.k_lin = Dense(c.dim, c.dim, dtype)
        self.v_lin = Dense(c.dim, c.dim, dtype)
        self.out_lin = Dense(c.dim, c.dim, dtype)

    def forward(self, x: torch.Tensor,
                key_valid: Optional[torch.Tensor]) -> torch.Tensor:
        c = self.config
        b, s, _ = x.shape
        dh = c.dim // c.n_heads

        def split(t):  # (B, S, D) -> (B, H, S, Dh) view
            return t.view(b, s, c.n_heads, dh).transpose(1, 2)

        ctx = multi_head_attention(split(self.q_lin(x)), split(self.k_lin(x)),
                                   split(self.v_lin(x)), key_valid,
                                   sm_scale=1.0 / dh ** 0.5,
                                   dropout_rate=(c.attention_dropout
                                                 if self.training else 0.0))
        return self.out_lin(ctx.transpose(1, 2).reshape(b, s, c.dim))


class FFN(nn.Module):
    def __init__(self, config: DistilBertConfig, dtype: torch.dtype):
        super().__init__()
        self.kind = config.gelu
        self.lin1 = Dense(config.dim, config.hidden_dim, dtype)
        self.lin2 = Dense(config.hidden_dim, config.dim, dtype)
        self.dropout = nn.Dropout(config.dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(self.lin2(gelu(self.lin1(x), self.kind)))


class TransformerBlock(nn.Module):
    """Post-LN: LN(attn(x) + x), then LN(ffn(h) + h)."""

    def __init__(self, config: DistilBertConfig, dtype: torch.dtype):
        super().__init__()
        c = config
        self.attention = MultiHeadSelfAttention(c, dtype)
        self.sa_layer_norm = LayerNorm(c.dim, c.layer_norm_eps, dtype)
        self.ffn = FFN(c, dtype)
        self.output_layer_norm = LayerNorm(c.dim, c.layer_norm_eps, dtype)

    def forward(self, x: torch.Tensor,
                key_valid: Optional[torch.Tensor]) -> torch.Tensor:
        h = self.sa_layer_norm(self.attention(x, key_valid) + x)
        return self.output_layer_norm(self.ffn(h) + h)


class Transformer(nn.Module):
    def __init__(self, config: DistilBertConfig, dtype: torch.dtype):
        super().__init__()
        self.layer = nn.ModuleList(TransformerBlock(config, dtype)
                                   for _ in range(config.n_layers))


class DistilBertModel(nn.Module):
    """Returns the last hidden state, shape (B, S, dim). With ``remat``
    each layer is recomputed in the backward (``layers.run_block``)."""

    def __init__(self, config: DistilBertConfig = DistilBertConfig(),
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.config, self.remat = config, remat
        self.embeddings = Embeddings(config, dtype)
        self.transformer = Transformer(config, dtype)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        # One fp32 (B, S) mask for every layer: the kernel reads it as is.
        key_valid = (None if attention_mask is None
                     else (attention_mask != 0).to(torch.float32))
        x = self.embeddings(input_ids)
        for block in self.transformer.layer:
            x = run_block(block, x, key_valid, remat=self.remat)
        return x


class TextEncoder(nn.Module):
    """CLS-token sentence embedding (reference modules.py:34-51)."""

    def __init__(self, config: DistilBertConfig = DistilBertConfig(),
                 dtype: torch.dtype = torch.float32,
                 target_token_idx: int = 0, remat: bool = False):
        super().__init__()
        self.model = DistilBertModel(config, dtype, remat)
        self.target_token_idx = target_token_idx

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        return self.model(input_ids, attention_mask)[:, self.target_token_idx]
