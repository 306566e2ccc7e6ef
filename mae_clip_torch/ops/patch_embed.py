"""Masked patch embedding: the visible-row gather fused with the projection
(``mae_clip_tpu/ops/patch_embed.py``).

``out[b] = patches[b, ids[b]] @ W.T + bias``, (B, N, Din) patches and (B, K)
indices -> (B, K, Dm), with W in torch's ``(Dm, Din)`` Linear layout.

* ``masked_patch_embed_ref``: the plain version, with the TPU kernel's
  numerics: the gathered rows are exact and then in the weight's type, the
  products accumulate in fp32, the bias is added in fp32, and the sum is
  rounded once to the type of ``patches``. (The default route, a gather
  then ``Dense``, rounds the product before it adds the bias, so the two can
  differ by one ulp in bf16.)
* ``masked_patch_embed``: the kernel wrapper, a ``torch.autograd.Function``
  as the JAX package's ``custom_vjp``. Its forward runs the plain version on
  a CPU tensor and launches the hand-written kernel of
  ``csrc/patch_embed.cu`` on a CUDA tensor, or raises; it counts the
  launches in ``masked_patch_embed.launches``. Its backward is plain torch
  on both devices, as JAX's is the XLA formulation: ``dW``, ``db``, and a
  ``dpatches`` scattered back to the gathered rows with ``index_add_``.
"""

from __future__ import annotations

import torch

from mae_clip_torch.ops.attention import (_DTYPE_CODES, _count, _ptr,
                                          _raise_on_error, _stream)


def masked_patch_embed_ref(patches: torch.Tensor, ids: torch.Tensor,
                           weight: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: (B, N, Din), (B, K), (Dm, Din), (Dm,)
    -> (B, K, Dm) in the type of ``patches``."""
    gathered = torch.take_along_dim(patches, ids[:, :, None], dim=1)
    out = torch.matmul(gathered.to(weight.dtype).float(), weight.float().t())
    return (out + bias.float()).to(patches.dtype)


def _check_inputs(patches, ids, weight, bias) -> None:
    tensors = (patches, ids, weight, bias)
    if any(t.device != patches.device for t in tensors) or \
            patches.device.type != "cuda":
        raise ValueError("masked_patch_embed: all inputs must lie on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if patches.dtype not in _DTYPE_CODES or any(
            t.dtype != patches.dtype for t in (weight, bias)):
        raise TypeError("masked_patch_embed: patches, weight and bias must "
                        "share one dtype, float32 or bfloat16; got "
                        f"{[t.dtype for t in (patches, weight, bias)]}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"masked_patch_embed: ids must be integer, got "
                        f"{ids.dtype}")
    b, _, d_in = patches.shape
    d_m = weight.shape[0]
    if (ids.dim() != 2 or ids.shape[0] != b or ids.shape[1] == 0
            or tuple(weight.shape) != (d_m, d_in)
            or tuple(bias.shape) != (d_m,)):
        raise ValueError(
            f"masked_patch_embed: bad shapes patches {tuple(patches.shape)} "
            f"ids {tuple(ids.shape)} weight {tuple(weight.shape)} bias "
            f"{tuple(bias.shape)}")


def _launch(patches, ids, weight, bias) -> torch.Tensor:
    from mae_clip_torch.ops._build import load_patch_embed

    lib = load_patch_embed()
    patches, weight, bias = (t.contiguous() for t in (patches, weight, bias))
    ids = ids.to(torch.int64).contiguous()
    b, n, d_in = patches.shape
    k, d_m = ids.shape[1], weight.shape[0]
    out = torch.empty((b, k, d_m), dtype=patches.dtype, device=patches.device)
    err = lib.masked_patch_embed_fwd(
        _ptr(patches), _ptr(ids), _ptr(weight), _ptr(bias), _ptr(out),
        b, n, d_in, k, d_m, _DTYPE_CODES[patches.dtype], _stream(patches))
    _raise_on_error(err, lib.patch_embed_error_string, "masked_patch_embed")
    _count(masked_patch_embed, "launches")
    return out


class _MaskedPatchEmbed(torch.autograd.Function):
    """Kernel #5 forward; the backward is plain torch (JAX's is XLA's)."""

    @staticmethod
    def forward(ctx, patches, ids, weight, bias):
        ctx.save_for_backward(patches, ids, weight)
        ctx.bias_dtype = bias.dtype
        if patches.device.type == "cpu":
            return masked_patch_embed_ref(patches, ids, weight, bias)
        return _launch(patches, ids, weight, bias)

    @staticmethod
    def backward(ctx, d_out):
        patches, ids, weight = ctx.saved_tensors
        b, n, d_in = patches.shape
        g = d_out.float().reshape(-1, d_out.shape[-1])        # (B*K, Dm)
        d_patches = d_weight = d_bias = None
        if ctx.needs_input_grad[2]:
            gathered = torch.take_along_dim(patches, ids[:, :, None], dim=1)
            d_weight = (g.t() @ gathered.reshape(-1, d_in).float()).to(
                weight.dtype)
        if ctx.needs_input_grad[3]:
            d_bias = g.sum(dim=0).to(ctx.bias_dtype)
        if ctx.needs_input_grad[0]:
            rows = (ids + n * torch.arange(b, device=ids.device)[:, None])
            d_patches = torch.zeros(b * n, d_in, dtype=torch.float32,
                                    device=patches.device).index_add_(
                0, rows.reshape(-1), g @ weight.float())
            d_patches = d_patches.view(b, n, d_in).to(patches.dtype)
        return d_patches, None, d_weight, d_bias


def masked_patch_embed(patches: torch.Tensor, ids: torch.Tensor,
                       weight: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """(B, N, Din) patches, (B, K) indices, (Dm, Din) weight, (Dm,) bias ->
    (B, K, Dm) in the type of ``patches``. On the card, ``patches``,
    ``weight`` and ``bias`` share one type (float32 or bfloat16); an index
    outside [0, N) gives a row of NaN there (the plain version raises)."""
    if patches.device.type != "cpu":
        _check_inputs(patches, ids, weight, bias)
    return _MaskedPatchEmbed.apply(patches, ids, weight, bias)


masked_patch_embed.launches = 0
