"""JAX/flax parameter tree -> the port's ``state_dict``.

``state_dict_from_flax`` takes the JAX package's ``CLIPModel`` variables
(or their ``params``) as a nested dict of numpy arrays
(``jax.tree_util.tree_map(np.asarray, variables)``; the JAX package is not
imported here) and returns the port's state_dict: image encoder, MAE
decoder and ``mask_token``, both projection heads and the ``logit_*``
scalars; for a ResNet tower also the ``batch_stats`` collection as the
BatchNorms' running buffers (``mean`` -> ``running_mean``, ``var`` ->
``running_var``, ``num_batches_tracked`` 0; without ``batch_stats`` the
buffers keep their initial 0 and 1). ``mae_state_dict_from_flax`` does the same for a
standalone ``MAEViT`` (the MAE-pretraining model: ``patch_embed``,
``block_i``, ``decoder_block_i``, ``mask_token``, ... at the top level).
Dense kernels ``(in, out)`` become torch weights ``(out, in)``;
convolution kernels HWIO become OIHW (axes ``(3, 2, 0, 1)``, as the
exporter's ``put_conv``: a plain transpose would give OIWH, which the
shape check cannot tell from OIHW for square kernels); LayerNorm and
BatchNorm ``scale`` and table ``embedding`` become ``weight``.
Module names follow timm/HF as the JAX package's exporter does
(``block_3/attn_qkv`` -> ``blocks.3.attn.qkv``, ``layer_0/ffn_lin1`` ->
``transformer.layer.0.ffn.lin1``, ``layer2_0/downsample_conv`` ->
``layer2.0.downsample.0``). ``block_stack_weights_from_jax`` converts
the stacked weights of the fused block stack.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from mae_clip_torch.config import Config
from mae_clip_torch.models.distilbert import DistilBertConfig

_LEAVES = {"kernel": "weight", "scale": "weight", "embedding": "weight",
           "mean": "running_mean", "var": "running_var"}
_MODULES = [
    (re.compile(r"^layer(\d+)_(\d+)$"), r"layer\1.\2"),
    (re.compile(r"^downsample_conv$"), "downsample.0"),
    (re.compile(r"^downsample_bn$"), "downsample.1"),
    (re.compile(r"^decoder_block_(\d+)$"), r"decoder_blocks.\1"),
    (re.compile(r"^block_(\d+)$"), r"blocks.\1"),
    (re.compile(r"^layer_(\d+)$"), r"transformer.layer.\1"),
    (re.compile(r"^attn_(qkv|proj|q|kv)$"), r"attn.\1"),
    (re.compile(r"^mlp_(fc1|fc2)$"), r"mlp.\1"),
    (re.compile(r"^ffn_(lin1|lin2)$"), r"ffn.\1"),
]


def _module_name(name: str) -> str:
    for pattern, repl in _MODULES:
        if pattern.match(name):
            return pattern.sub(repl, name)
    return name


def _flatten(tree: Mapping[str, Any], prefix: str, out: Dict[str, Any]):
    for name, node in tree.items():
        if isinstance(node, Mapping):
            _flatten(node, prefix + _module_name(name) + ".", out)
            continue
        arr = np.asarray(node, dtype=np.float32)
        if name == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        out[prefix + _LEAVES.get(name, name)] = torch.from_numpy(
            np.array(arr, order="C"))  # a writable copy, 0-d kept 0-d
        if name == "var":
            out[prefix + "num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long)


def _converted(params: Mapping[str, Any],
               want: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    if "params" in params:
        if "batch_stats" in params:
            _flatten(params["batch_stats"], "", sd)
        params = params["params"]
    _flatten(params, "", sd)
    if not any(k.endswith("running_var") for k in sd):
        # No batch_stats given: the BatchNorms keep their initial buffers.
        initial = {"running_mean": torch.zeros, "running_var": torch.ones,
                   "num_batches_tracked": lambda shape: torch.zeros(
                       shape, dtype=torch.long)}
        sd.update({k: initial[k.rsplit(".", 1)[-1]](v.shape)
                   for k, v in want.items()
                   if k.rsplit(".", 1)[-1] in initial})
    missing, extra = sorted(set(want) - set(sd)), sorted(set(sd) - set(want))
    if missing or extra:
        raise KeyError(f"param trees differ: missing {missing[:8]}, "
                       f"unexpected {extra[:8]}")
    for k, v in sd.items():
        if v.shape != want[k].shape:
            raise ValueError(f"{k}: shape {tuple(v.shape)} != "
                             f"{tuple(want[k].shape)}")
    return sd


def state_dict_from_flax(params: Mapping[str, Any], cfg: Config,
                         text_config: DistilBertConfig = DistilBertConfig(),
                         vit_config=None,
                         resnet_shape=None) -> Dict[str, torch.Tensor]:
    """Convert a flax ``CLIPModel`` param tree (``variables``, with or
    without ``batch_stats``, or ``variables["params"]``) for the port's
    ``CLIPModel(cfg, text_config, vit_config, resnet_shape=...)``. Raises if
    a key or a shape differs from that model's."""
    from mae_clip_torch.models.clip import CLIPModel

    with torch.device("meta"):
        want = CLIPModel(cfg, text_config, vit_config, device="meta",
                         resnet_shape=resnet_shape).state_dict()
    return _converted(params, want)


def mae_state_dict_from_flax(params: Mapping[str, Any], cfg: Config,
                             vit_config=None) -> Dict[str, torch.Tensor]:
    """Convert a flax standalone ``MAEViT`` param tree (``mae_vit_for(cfg,
    vit_config)`` in the JAX package) for the port's ``mae_vit_for(cfg,
    vit_config)``. Raises if a key or a shape differs from that model's."""
    from mae_clip_torch.models.clip import mae_vit_for

    with torch.device("meta"):
        want = mae_vit_for(cfg, vit_config, device="meta").state_dict()
    return _converted(params, want)


def block_stack_weights_from_jax(w: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's stacked ``fused_block_stack`` weights (numpy, each
    ``(L, ...)``, matrices ``(L, in, out)``) as the port's: matrices
    ``(L, out, in)``, everything else as it is, in the arrays' dtype."""
    return {k: torch.from_numpy(np.ascontiguousarray(
        np.swapaxes(v, 1, 2) if np.ndim(v) == 3 else np.asarray(v)))
        for k, v in w.items()}
