"""The port's towers (mae_clip_torch.models) against the JAX package's.

Weights come from the JAX model's ``init`` through ``state_dict_from_flax``
and load strictly; inputs are made with numpy from a seed. fp32 on the CPU,
atol 1e-4 / rtol 1e-4.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mae_clip_tpu import config as jax_config
from mae_clip_tpu.models import clip as jax_clip
from mae_clip_tpu.models import distilbert as jax_distilbert
from mae_clip_tpu.models import vit as jax_vit
from mae_clip_torch import config as torch_config
from mae_clip_torch.interop.from_jax import state_dict_from_flax
from mae_clip_torch.models import CLIPModel, DistilBertConfig, ViTConfig
from mae_clip_torch.models import vit as torch_vit
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-4, rtol=1e-4)
TEXT = dict(vocab_size=50, dim=32, n_layers=2, n_heads=4, hidden_dim=64,
            max_position_embeddings=32)
VIT = dict(image_size=16, patch_size=8, dim=32, depth=2, n_heads=2)

# (name, Config kwargs, explicit ViTConfig kwargs or None)
CASES = {
    # Flagship-like: MAE tower (sincos, CrossMAE decoder params), tanh GELU,
    # text head override (4 -> 1 head of 32), SigLIP scalars.
    "mae_tanh_siglip": dict(
        cfg=dict(gelu_impl="tanh", text_heads=1, contrastive_loss="siglip",
                 mae=dict(enabled=True, decoder_style="cross", decoder_dim=16,
                          decoder_depth=1, decoder_heads=1)),
        vit=dict(VIT, n_heads=1)),
    # Plain ViT tower (learned positions), erf GELU, learnable temperature,
    # MAE-paper full decoder style unused.
    "vit_erf_temperature": dict(
        cfg=dict(contrastive_loss="clip", learnable_temperature=True,
                 temperature=0.5),
        vit=VIT),
    # MAE tower with the full (self-attention) decoder's params.
    "mae_full_decoder": dict(
        cfg=dict(mae=dict(enabled=True, decoder_style="full", decoder_dim=16,
                          decoder_depth=1, decoder_heads=2)),
        vit=VIT),
}


def _configs(kw):
    base = dict(model_name="vit_s16", projection_dim=8, size=16,
                compute_dtype="float32")
    base.update({k: v for k, v in kw.items() if k != "mae"})
    mae = kw.get("mae", {})
    return (jax_config.Config(**base, mae=jax_config.MAEConfig(**mae)),
            torch_config.Config(**base, mae=torch_config.MAEConfig(**mae)))


def _inputs(seed=0, b=3, s=9):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(b, 16, 16, 3)).astype(np.float32)
    ids = rng.integers(0, TEXT["vocab_size"], (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, 5:] = 0
    mask[2, 2:] = 0
    return img, ids, mask


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    """(jax model, jax variables, port model) sharing one set of weights."""
    case = CASES[request.param]
    jcfg, tcfg = _configs(case["cfg"])
    jmodel = jax_clip.CLIPModel(
        jcfg, text_config=jax_distilbert.DistilBertConfig(**TEXT),
        vit_config=jax_vit.ViTConfig(**case["vit"]))
    img, ids, mask = _inputs()
    batch = {"image": jnp.asarray(img), "input_ids": jnp.asarray(ids),
             "attention_mask": jnp.asarray(mask)}
    variables = jax.jit(lambda r, b: jmodel.init(
        r, b, mask_rng=jax.random.PRNGKey(1)))(jax.random.PRNGKey(0), batch)
    params = jax.tree_util.tree_map(np.asarray, variables)
    text_cfg, vit_cfg = DistilBertConfig(**TEXT), ViTConfig(**case["vit"])
    tmodel = CLIPModel(tcfg, text_cfg, vit_cfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(params, tcfg, text_cfg,
                                                vit_cfg), strict=True)
    return jmodel, variables, tmodel


def test_image_tower_matches_jax(pair):
    """encode_image: MAEViT.encode_full or ViTEncoder, per case."""
    jmodel, variables, tmodel = pair
    img, _, _ = _inputs(1)
    want = jmodel.apply(variables, jnp.asarray(img), method=jmodel.encode_image)
    with torch.no_grad():
        got = tmodel.encode_image(torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prepatchified_input_matches_nhwc(pair):
    _, _, tmodel = pair
    img, _, _ = _inputs(2)
    x = torch.from_numpy(img)
    with torch.no_grad():
        a = tmodel.encode_image(x)
        b = tmodel.encode_image(torch_vit.patchify(x, 8))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_text_tower_matches_jax(pair):
    """DistilBERT CLS features with a padding mask."""
    jmodel, variables, tmodel = pair
    _, ids, mask = _inputs(3)
    want = jmodel.apply(variables, jnp.asarray(ids), jnp.asarray(mask),
                        method=jmodel.encode_text)
    with torch.no_grad():
        got = tmodel.encode_text(torch.from_numpy(ids).long(),
                                 torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_projection_heads_match_jax(pair):
    jmodel, variables, tmodel = pair
    rng = np.random.default_rng(4)
    fi = rng.normal(size=(4, tmodel.image_projection.projection.in_features))
    ft = rng.normal(size=(4, tmodel.text_projection.projection.in_features))
    fi, ft = fi.astype(np.float32), ft.astype(np.float32)
    with torch.no_grad():
        gi = tmodel.project_image(torch.from_numpy(fi)).numpy()
        gt = tmodel.project_text(torch.from_numpy(ft)).numpy()
    np.testing.assert_allclose(gi, np.asarray(jmodel.apply(
        variables, jnp.asarray(fi), method=jmodel.project_image)), **TOL)
    np.testing.assert_allclose(gt, np.asarray(jmodel.apply(
        variables, jnp.asarray(ft), method=jmodel.project_text)), **TOL)


def test_clip_embeddings_match_jax(pair):
    """The full embed functions (uint8 normalisation, tower, projection),
    as retrieval and serving call them."""
    from mae_clip_tpu.eval import retrieval as jax_eval
    from mae_clip_torch.eval import retrieval as torch_eval

    jmodel, variables, tmodel = pair
    rng = np.random.default_rng(5)
    pix = rng.integers(0, 256, (2, 16, 16, 3)).astype(np.uint8)
    _, ids, mask = _inputs(6)
    want_i = jax_eval._image_embed_fn(jmodel)(variables, jnp.asarray(pix))
    want_t = jax_eval._text_embed_fn(jmodel)(variables, jnp.asarray(ids),
                                             jnp.asarray(mask))
    got_i = torch_eval._image_embed_fn(tmodel)(pix)
    got_t = torch_eval._text_embed_fn(tmodel)(ids.astype(np.int64), mask)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), **TOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), **TOL)


def test_batched_embedding_helpers_match_jax(pair):
    """compute_text_embeddings (chunked) and compute_image_embeddings (a
    loader whose ``valid`` rows drop the padded tail) as in JAX."""
    from mae_clip_tpu.eval import retrieval as jax_eval
    from mae_clip_torch.eval import retrieval as torch_eval

    jmodel, variables, tmodel = pair
    rng = np.random.default_rng(8)
    ids = rng.integers(0, TEXT["vocab_size"], (5, 7)).astype(np.int32)
    mask = np.ones((5, 7), np.int32)
    mask[3, 4:] = 0
    want = jax_eval.compute_text_embeddings(jmodel, variables, ids, mask, 2)
    got = torch_eval.compute_text_embeddings(tmodel, ids.astype(np.int64),
                                             mask, 2)
    np.testing.assert_allclose(got, want, **TOL)

    pix = rng.integers(0, 256, (4, 16, 16, 3)).astype(np.uint8)
    batches = [{"image": pix[:2]},
               {"image": pix[2:], "valid": np.array([True, False])}]
    want = jax_eval.compute_image_embeddings(jmodel, variables, batches)
    got = torch_eval.compute_image_embeddings(tmodel, batches)
    assert got.shape == (3, tmodel.cfg.projection_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_logit_params_carried(pair):
    _, variables, tmodel = pair
    params = variables["params"]
    for name in ("logit_scale", "logit_bias"):
        assert hasattr(tmodel, name) == (name in params)
        if name in params:
            assert float(getattr(tmodel, name).detach()) == pytest.approx(
                float(params[name]))


def test_state_dict_from_flax_rejects_other_geometry(pair):
    """A param tree converted for another geometry is refused by key/shape."""
    _, variables, tmodel = pair
    params = jax.tree_util.tree_map(np.asarray, variables)
    tcfg = tmodel.cfg
    wider = dict(TEXT, hidden_dim=48)
    with pytest.raises(ValueError, match="shape"):
        state_dict_from_flax(params, tcfg, DistilBertConfig(**wider),
                             tmodel.vit_config)
    # Drop the logit scalars where the tree has them, else ask for them.
    other = (tcfg.replace(contrastive_loss="softmax",
                          learnable_temperature=False)
             if "logit_scale" in params["params"]
             else tcfg.replace(contrastive_loss="siglip"))
    with pytest.raises(KeyError, match="logit"):
        state_dict_from_flax(params, other, tmodel.text_config,
                             tmodel.vit_config)


@pytest.mark.parametrize("kw", [
    dict(model_name="vit_s16"),
    dict(model_name="vit_b16", size=32),
    dict(model_name="vit_s16", gelu_impl="tanh", image_heads=3),
    dict(model_name="vit_s16", image_heads=5),       # 384 % 5: ignored
    dict(model_name="vit_s16", mae=dict(enabled=True), gelu_impl="erf"),
])
def test_resolved_vit_config_matches_jax(kw):
    """Tower geometry (head/GELU overrides, sincos for MAE) as in JAX."""
    jcfg, tcfg = _configs(kw)
    want = jax_clip._resolved_vit_config(jcfg, None)
    got = torch_vit._resolved_vit_config(tcfg, None)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_sincos_and_patchify_match_jax():
    np.testing.assert_array_equal(
        torch_vit.sincos_pos_embed_2d(32, 4, cls_token=True),
        jax_vit.sincos_pos_embed_2d(32, 4, cls_token=True))
    img = np.random.default_rng(7).normal(size=(2, 16, 16, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        torch_vit.patchify(torch.from_numpy(img), 8).numpy(),
        np.asarray(jax_vit.patchify(jnp.asarray(img), 8)))


def test_unported_paths_raise():
    """The ResNet50 tower is ported and a ResNet CLIP builds on the CPU;
    both MAE decoders run: the MAE-paper 'full' one predicts every patch,
    the 'cross' one the masked patches."""
    _, tcfg = _configs(dict(mae=dict(enabled=True, decoder_style="full",
                                     decoder_dim=16, decoder_depth=1,
                                     decoder_heads=2)))
    model = CLIPModel(tcfg, DistilBertConfig(**TEXT), ViTConfig(**VIT),
                      device="cpu")
    img = torch.zeros(1, 16, 16, 3)
    full = model.image_encoder(img, torch.Generator().manual_seed(0))
    assert full.pred_patches.shape == full.target_patches.shape == (1, 4, 192)
    assert full.mask.shape == (1, 4) and float(full.mask.sum()) == 3.0
    cross = CLIPModel(tcfg.replace(mae=dataclasses.replace(
        tcfg.mae, decoder_style="cross")), DistilBertConfig(**TEXT),
        ViTConfig(**VIT), device="cpu")
    assert cross.image_encoder(img).pred_patches.shape == (1, 3, 192)
    resnet = CLIPModel(tcfg.replace(model_name="resnet50",
                                    mae=torch_config.MAEConfig()),
                       DistilBertConfig(**TEXT), device="cpu")
    assert resnet.image_encoder.out_dim == 2048
    assert resnet.encode_image(torch.zeros(1, 32, 32, 3)).shape == (1, 2048)


def test_seeded_init_is_reproducible():
    _, tcfg = _configs({})
    def make():
        return CLIPModel(tcfg, DistilBertConfig(**TEXT), ViTConfig(**VIT),
                         device="cpu").init_weights(
                             torch.Generator().manual_seed(3))
    a, b = make().state_dict(), make().state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    ln = a["image_encoder.norm.weight"]
    assert torch.equal(ln, torch.ones_like(ln))
