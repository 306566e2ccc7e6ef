"""The port's MAE-pretraining slice against the JAX package's.

A ``mae_pretrain_config`` model cut to image 32, patch 8, an encoder of two
blocks of width 32 (2 heads) and the MAE-paper ('full') decoder of one block
of width 32 (2 heads), tanh GELU, with the JAX model's parameter tree
filled from a numpy seed and converted through ``mae_state_dict_from_flax``.
The JAX side runs attention through XLA; the masked patch embedding (kernel
#5) runs its Pallas kernel in interpret mode. The MAE masks come from JAX's
``random_masking`` and are fed to both sides; the in-step crops are compared
given JAX's boxes and flips. fp32 on the CPU.

Tolerances: values atol 1e-4 / rtol 1e-4 (as the other tower tests); the
patch embedding alone, values and gradients, 1e-5 (one GEMM); in bf16 one
bf16 ulp of the largest output (the sum is rounded once, after fp32 sums in
another order); crops 1e-3 on the 0..255 scale; parameters after AdamW
updates as ``test_torch_train.py`` holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mae_clip_tpu import config as jax_config
from mae_clip_tpu.interop import transfer as jax_transfer
from mae_clip_tpu.models import clip as jax_clip
from mae_clip_tpu.models import distilbert as jax_distilbert
from mae_clip_tpu.models import vit as jax_vit
from mae_clip_tpu.ops import augment as jax_augment
from mae_clip_tpu.ops import masking as jax_masking
from mae_clip_tpu.ops import patch_embed as jax_patch_embed
from mae_clip_tpu.train import loop as jax_loop
from mae_clip_tpu.train import optim as jax_optim
from mae_clip_tpu.train.state import TrainState as JaxTrainState
from mae_clip_torch import config as torch_config
from mae_clip_torch.interop import from_jax
from mae_clip_torch.interop.transfer import load_mae_encoder_into_clip
from mae_clip_torch.models import (CLIPModel, DistilBertConfig, MAEViT,
                                   ViTConfig, mae_vit_for)
from mae_clip_torch.ops import augment
from mae_clip_torch.ops.masking import (MaskingResult,
                                        scatter_with_mask_tokens)
from mae_clip_torch.ops.patch_embed import (masked_patch_embed,
                                            masked_patch_embed_ref)
from mae_clip_torch.train import (TrainState, make_eval_step,
                                  make_mae_eval_step, make_mae_pretrain_step,
                                  make_optimizer, make_train_step)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-4, rtol=1e-4)
B = 4
SIZE, PATCH, SOURCE = 32, 8, 40
N_PATCHES = (SIZE // PATCH) ** 2
PATCH_DIM = PATCH * PATCH * 3
VIT = dict(image_size=SIZE, patch_size=PATCH, dim=32, depth=2, n_heads=2)
TEXT = dict(vocab_size=50, dim=32, n_layers=1, n_heads=2, hidden_dim=64,
            max_position_embeddings=32)
CFG = dict(batch_size=B, size=SIZE, image_embedding=32, projection_dim=8,
           compute_dtype="float32", lr=1e-3)
MAE = dict(enabled=True, decoder_style="full", mask_ratio=0.75,
           decoder_dim=32, decoder_depth=1, decoder_heads=2,
           aug_source_size=SOURCE)


def _configs(**mae):
    mae = dict(MAE, **mae)
    return (jax_config.mae_pretrain_config(
                **CFG, mae=jax_config.MAEConfig(**mae)),
            torch_config.mae_pretrain_config(
                **CFG, mae=torch_config.MAEConfig(**mae)))


def _fill(shapes, seed):
    """A parameter tree of ``shapes`` from a numpy seed: kernels normal /
    sqrt(fan_in), LayerNorm scales 1 + 0.1 * normal, biases, tables and
    tokens 0.02 * normal (nonzero biases exercise more than zeros)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        x = rng.normal(size=leaf.shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(leaf.shape[0])
        return 1.0 + 0.1 * x if name == "scale" else 0.02 * x

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _patches(seed):
    return np.random.default_rng(seed).integers(
        0, 256, (B, N_PATCHES, PATCH_DIM)).astype(np.uint8)


def _jax_masking(rng, step):
    """The masks JAX's pretrain step draws at ``step``."""
    return jax_masking.random_masking(
        jax.random.fold_in(jax.random.fold_in(rng, step), 2), B, N_PATCHES,
        MAE["mask_ratio"])


def _torch_masking(m) -> MaskingResult:
    return MaskingResult(*(torch.tensor(np.asarray(x, np.float32)) if i == 2
                           else torch.tensor(np.asarray(x, np.int64))
                           for i, x in enumerate(m)))


def _torch_model(tcfg, params, **kw):
    model = mae_vit_for(tcfg, ViTConfig(**VIT), device="cpu")
    if kw:
        model = MAEViT(model.config, model.decoder, model.mask_ratio,
                       decoder_style=model.decoder_style, **kw)
    model.load_state_dict(from_jax.mae_state_dict_from_flax(
        params, tcfg, ViTConfig(**VIT)), strict=True)
    return model


@pytest.fixture(scope="module")
def setup():
    """The JAX MAEViT and its seeded weights, shared by this file."""
    jcfg, tcfg = _configs()
    jmodel = jax_clip.mae_vit_for(jcfg, jax_vit.ViTConfig(**VIT))
    shapes = jax.eval_shape(
        lambda r: jmodel.init(r, jnp.zeros((B, N_PATCHES, PATCH_DIM)),
                              jax.random.PRNGKey(1)), jax.random.PRNGKey(0))
    return jcfg, tcfg, jmodel, _fill(shapes["params"], 0)


# ---------------------------------------------------------------------------
# Kernel #5's plain version, the scatter, the crops
# ---------------------------------------------------------------------------

def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("b,n,d_in,k,d_m", [(2, 16, 24, 4, 8),
                                            (3, 20, 48, 7, 40),
                                            (5, 40, 200, 29, 136)])
def test_masked_patch_embed_ref_matches_jax(b, n, d_in, k, d_m):
    """The plain version (and the wrapper, which runs it on the CPU)
    against JAX's Pallas kernel in interpret mode: values and the gradients
    in patches, W and b at fp32; values at bf16."""
    rng = np.random.default_rng(k)
    p = rng.normal(size=(b, n, d_in)).astype(np.float32)
    ids = np.stack([rng.choice(n, size=k, replace=False) for _ in range(b)])
    w = rng.normal(size=(d_in, d_m)).astype(np.float32)
    bias = rng.normal(size=(d_m,)).astype(np.float32)
    g = rng.normal(size=(b, k, d_m)).astype(np.float32)
    jids = jnp.asarray(ids, jnp.int32)

    def jax_fn(p_, w_, b_):
        return jax_patch_embed.masked_patch_embed(p_, jids, w_, b_, True)

    want, vjp = jax.vjp(jax_fn, *(jnp.asarray(x) for x in (p, w, bias)))
    want_g = vjp(jnp.asarray(g))
    tp, tw, tb = (torch.from_numpy(x).requires_grad_()
                  for x in (p, w.T.copy(), bias))
    tids = torch.from_numpy(ids)
    before = masked_patch_embed.launches
    got = masked_patch_embed(tp, tids, tw, tb)
    got_g = torch.autograd.grad(got, (tp, tw, tb), torch.from_numpy(g))
    assert masked_patch_embed.launches == before
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(
        masked_patch_embed_ref(tp, tids, tw, tb).detach().numpy(),
        np.asarray(want), **tol)
    for name, x, y in zip(("patches", "W", "b"), got_g, want_g):
        y = np.asarray(y).T if name == "W" else np.asarray(y)
        np.testing.assert_allclose(x.numpy(), y, **tol, err_msg=name)

    jb = [jnp.asarray(x, jnp.bfloat16) for x in (p, w, bias)]
    want16 = np.asarray(jax_fn(*jb).astype(jnp.float32))

    def bf16(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)

    got16 = masked_patch_embed_ref(bf16(jb[0]), tids, bf16(jb[1].T),
                                   bf16(jb[2]))
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), want16, rtol=0,
                               atol=_bf16_ulp(np.abs(want16).max()))


def test_scatter_with_mask_tokens_matches_jax():
    rng = np.random.default_rng(3)
    m = jax_masking.random_masking(jax.random.PRNGKey(4), 3, 10, 0.6)
    x = rng.normal(size=(3, 4, 5)).astype(np.float32)
    tok = rng.normal(size=(1, 1, 5)).astype(np.float32)
    want = jax_masking.scatter_with_mask_tokens(
        jnp.asarray(x), jnp.asarray(tok), m.ids_restore)
    got = scatter_with_mask_tokens(torch.from_numpy(x), torch.from_numpy(tok),
                                   _torch_masking(m).ids_restore)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _sources(seed, b=B, s=SOURCE):
    return np.random.default_rng(seed).integers(
        0, 256, (b, s, s, 3)).astype(np.uint8)


def test_crop_resize_flip_matches_jax():
    """Given JAX's boxes and flips (the split of its key inside
    random_resized_crop_flip_batch), the port's resample gives JAX's crops;
    resize_batch gives JAX's resize. Some crops are smaller than the
    output (upsampling, where the edge clamp matters)."""
    imgs = _sources(5, b=8)
    key = jax.random.PRNGKey(11)
    want = jax_augment.random_resized_crop_flip_batch(jnp.asarray(imgs), key,
                                                      SIZE)
    k_box, k_flip = jax.random.split(key)
    boxes = jax_augment.sample_crop_boxes(k_box, 8, SOURCE)
    flip = np.asarray(jax.random.uniform(k_flip, (8,)) < 0.5)
    assert 0 < flip.sum() < 8 and float(np.min(boxes[2])) < SIZE
    got = augment.crop_resize_flip(
        torch.from_numpy(imgs),
        tuple(torch.tensor(np.asarray(x)) for x in boxes),
        torch.tensor(flip), SIZE)
    assert got.dtype == torch.float32 and got.shape == (8, SIZE, SIZE, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(
        augment.resize_batch(torch.from_numpy(imgs), SIZE).numpy(),
        np.asarray(jax_augment.resize_batch(jnp.asarray(imgs), SIZE)),
        atol=1e-3, rtol=0)


def test_sample_crop_boxes_invariants():
    """Integral boxes inside the frame, area and aspect in range unless the
    full frame was the fallback, one draw per seed, on the generator's
    device; the flips of random_resized_crop_flip_batch mirror the crop."""
    s, n = 40, 512
    i, j, ch, cw = augment.sample_crop_boxes(
        torch.Generator().manual_seed(0), n, s)
    for x in (i, j, ch, cw):
        assert x.shape == (n,) and x.dtype == torch.float32
        assert x.device.type == "cpu" and torch.equal(x, x.round())
    assert bool(((i >= 0) & (j >= 0) & (ch >= 1) & (cw >= 1)).all())
    assert bool(((i + ch <= s) & (j + cw <= s)).all())
    crop = (ch < s) | (cw < s)
    area = ch * cw / (s * s)
    assert bool((area[crop] >= 0.2 * 0.85).all())
    assert bool(((cw / ch)[crop] > 0.7).all() and ((cw / ch)[crop] < 1.43).all())
    assert len(set(area.tolist())) > 50
    again = augment.sample_crop_boxes(torch.Generator().manual_seed(0), n, s)
    assert all(torch.equal(a, b) for a, b in zip((i, j, ch, cw), again))

    imgs = torch.from_numpy(_sources(6, b=2))
    out = [augment.random_resized_crop_flip_batch(
        imgs, torch.Generator().manual_seed(1), SIZE, scale=(1.0, 1.0),
        ratio=(1.0, 1.0), hflip=h) for h in (0.0, 1.0)]
    torch.testing.assert_close(out[1], out[0].flip(2), atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# The 'full' MAEViT forward, the pretrain and eval steps, the bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", [False, True])
def test_mae_full_forward_matches_jax(setup, kernel):
    """MAEViT.forward with the MAE-paper decoder, by the default route and
    with the masked patch-embed opt-in (JAX's use_pallas_patch_embed, its
    kernel in interpret mode), fed masks: pooled CLS, pred and target for
    every patch, and the mask."""
    _, tcfg, jmodel, params = setup
    if kernel:
        jmodel = jmodel.clone(use_pallas_patch_embed=True,
                              attn_interpret=True)
    x = np.random.default_rng(2).normal(
        size=(B, SIZE, SIZE, 3)).astype(np.float32)
    masking = _jax_masking(jax.random.PRNGKey(6), 0)
    want = jax.jit(lambda p: jmodel.apply({"params": p}, jnp.asarray(x),
                                          None, masking=masking))(params)
    tmodel = _torch_model(tcfg, params, use_patch_embed_kernel=kernel)
    assert tmodel.patch_embed.masked_kernel is kernel
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), masking=_torch_masking(masking))
    assert got.pred_patches.shape == (B, N_PATCHES, PATCH_DIM)
    for name, a, b in zip(got._fields, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=name)


def _batch(images):
    return {"image": images, "valid": np.array([True] * (B - 1) + [False])}


def _assert_params_match(tmodel, jparams, small, tcfg, lr, steps):
    """Every parameter after the updates; ``small`` marks where a step's
    gradient was below 1e-6 (Adam's first steps divide by |g|)."""
    want = from_jax.mae_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, ViTConfig(**VIT))
    got = tmodel.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        atol = torch.where(small.get(name, torch.tensor(False)),
                           2 * lr * steps, 1e-6)
        err = (got[name] - w).abs()
        bad = err > atol + 1e-5 * w.abs()
        assert not bool(bad.any()), (name, float(err.max()))


def test_mae_pretrain_steps_match_jax(setup):
    """One and two steps of make_mae_pretrain_step against JAX's jitted
    step, uint8 patches with a padded row: the loss, and every parameter
    after each AdamW update (all labelled "head": lr, weight decay 0.05)."""
    jcfg, tcfg, jmodel, params = setup
    tx = jax_optim.make_optimizer(jcfg, params)
    rng0 = jax.random.PRNGKey(2)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.array, params),
                                  tx, jax.random.PRNGKey(2))  # donated
    jstep = jax_loop.make_mae_pretrain_step(jmodel, tx, jcfg)
    tmodel = _torch_model(tcfg, params)
    opt = make_optimizer(tcfg, tmodel)
    assert [g["name"] for g in opt.param_groups] == ["head"]
    assert opt.param_groups[0]["weight_decay"] == 0.05
    state = TrainState.create(tmodel, opt, cfg=tcfg)
    step = make_mae_pretrain_step(tmodel, opt, tcfg)
    small = {}
    for i, seed in enumerate((8, 9)):
        batch = _batch(_patches(seed))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tm = step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                  masking=_torch_masking(_jax_masking(rng0, i)))
        for name, p in tmodel.named_parameters():
            small[name] = small.get(name, False) | (p.grad.abs() < 1e-6)
        assert tmodel.training and state.step == i + 1 == int(jstate.step)
        assert set(tm) == set(jm) == {"loss", "mae_loss"}
        for k in jm:
            assert tm[k].dim() == 0
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL,
                                       err_msg=k)
        _assert_params_match(tmodel, jstate.params, small, tcfg, tcfg.lr,
                             i + 1)


def test_mae_eval_step_matches_jax(setup):
    """make_mae_eval_step against JAX's on uint8 sources at
    mae.aug_source_size (the full-frame resize of eval), with a padded
    row."""
    jcfg, tcfg, jmodel, params = setup
    rng0 = jax.random.PRNGKey(3)
    jstate = JaxTrainState.create(params, jax_optim.make_optimizer(
        jcfg, params), rng0)
    batch = _batch(_sources(10))
    want = jax_loop.make_mae_eval_step(jmodel, jcfg)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tmodel = _torch_model(tcfg, params)
    state = TrainState.create(tmodel, make_optimizer(tcfg, tmodel), cfg=tcfg)
    got = make_mae_eval_step(tmodel, tcfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()},
        masking=_torch_masking(_jax_masking(rng0, 0)))
    assert not tmodel.training
    for k in ("loss", "mae_loss"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), **TOL,
                                   err_msg=k)


def _flax_path_to_torch(path: str) -> str:
    *mods, leaf = path.split("/")
    return ".".join([from_jax._module_name(m) for m in mods]
                    + [from_jax._LEAVES.get(leaf, leaf)])


@pytest.mark.parametrize("tower", ["mae", "vit"])
def test_transfer_into_clip_matches_jax(setup, tower):
    """The MAEViT bridge loads strictly (the fixture's model), and
    load_mae_encoder_into_clip moves the same tensors as JAX's: every one
    into a MAE-enabled tower, the encoder into a plain ViT tower (the
    decoder and mask token skipped)."""
    jcfg, tcfg, _, params = setup
    mae = _torch_model(tcfg, params)
    if tower == "vit":
        jcfg = jcfg.replace(mae=jax_config.MAEConfig())
        tcfg = tcfg.replace(mae=torch_config.MAEConfig())
    jclip = jax_clip.CLIPModel(
        jcfg, text_config=jax_distilbert.DistilBertConfig(**TEXT),
        vit_config=jax_vit.ViTConfig(**VIT))
    jbatch = {"image": jnp.zeros((B, SIZE, SIZE, 3)),
              "input_ids": jnp.zeros((B, 5), jnp.int32),
              "attention_mask": jnp.ones((B, 5), jnp.int32)}
    clip_params = _fill(jax.eval_shape(lambda r: jclip.init(
        r, jbatch, mask_rng=jax.random.PRNGKey(1)),
        jax.random.PRNGKey(0))["params"], 1)
    _, jmoved, jskipped = jax_transfer.load_mae_encoder_into_clip(
        clip_params, params)

    clip = CLIPModel(tcfg, DistilBertConfig(**TEXT), ViTConfig(**VIT),
                     device="cpu")
    sd, moved, skipped = load_mae_encoder_into_clip(clip.state_dict(),
                                                    mae.state_dict())
    assert sorted(moved) == sorted(map(_flax_path_to_torch, jmoved))
    assert sorted(skipped) == sorted(map(_flax_path_to_torch, jskipped))
    assert (not skipped) == (tower == "mae")
    clip.load_state_dict(sd, strict=True)
    mae_sd = mae.state_dict()
    for name in moved:
        assert torch.equal(clip.image_encoder.state_dict()[name],
                           mae_sd[name]), name


# ---------------------------------------------------------------------------
# Evals are deterministic in the state
# ---------------------------------------------------------------------------

def _tiny_clip(seed):
    cfg = torch_config.flagship_tpu_config(
        **CFG, dropout=0.0, mae=torch_config.MAEConfig(
            enabled=True, decoder_style="cross", decoder_dim=32,
            decoder_depth=1, decoder_heads=2, aug_source_size=SOURCE))
    model = CLIPModel(cfg, DistilBertConfig(**TEXT), ViTConfig(**VIT),
                      device="cpu")
    return cfg, model.init_weights(torch.Generator().manual_seed(seed))


def _tiny_mae(seed):
    _, cfg = _configs()
    return cfg, mae_vit_for(cfg, ViTConfig(**VIT), device="cpu").init_weights(
        torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("objective", ["clip", "mae"])
def test_eval_is_deterministic_in_the_state(objective):
    """Two evals at one state agree exactly, and an eval between two
    training steps leaves the second step (its crops and masks) as it is
    without the eval: evals draw from their own generator, seeded from the
    state's seed and step, as JAX's eval folds the step into its key."""
    make, train, evaluate = {
        "clip": (_tiny_clip, make_train_step, make_eval_step),
        "mae": (_tiny_mae, make_mae_pretrain_step, make_mae_eval_step)}[
            objective]
    batch = {"image": torch.from_numpy(_sources(12)),
             "valid": torch.ones(B, dtype=torch.bool)}
    if objective == "clip":
        batch["text_features"] = torch.from_numpy(np.random.default_rng(
            12).normal(size=(B, TEXT["dim"])).astype(np.float32))
    runs = []
    for with_eval in (True, False):
        cfg, model = make(0)
        opt = make_optimizer(cfg, model)
        state = TrainState.create(model, opt, seed=5, cfg=cfg)
        step, ev = train(model, opt, cfg), evaluate(model, cfg)
        losses = [float(step(state, batch)["loss"])]
        if with_eval:
            e1, e2 = ev(state, batch), ev(state, batch)
            assert all(torch.equal(e1[k], e2[k]) for k in e1)
        losses.append(float(step(state, batch)["loss"]))
        runs.append((losses, model.state_dict()))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(v, runs[1][1][k]) for k, v in runs[0][1].items())
