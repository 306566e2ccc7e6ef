"""The port's training step (mae_clip_torch.train) against the JAX package's.

A flagship-shaped model cut to two layers of width 32 (16x16 images, patch
8, CrossMAE decoder of two blocks, tanh GELU, dropout 0) with the JAX
model's parameter tree, filled from a numpy seed and converted through
``state_dict_from_flax``. The JAX reference
runs its Pallas attention kernels in interpret mode: the packed kernels
(#1/#3) in the encoder, the flash kernels (#2/#4) in the decoder. The MAE
mask indices come from JAX's ``random_masking`` and are fed to both sides.
fp32 on the CPU.

Tolerances: values atol 1e-4 / rtol 1e-4 (as the tower tests); gradients
atol 1e-5 / rtol 1e-3 (sums of many small products in another order);
parameters after AdamW updates atol 1e-6 / rtol 1e-5, except where a
step's gradient is below 1e-6 in magnitude: Adam's first steps divide by
|g|, so there a rounding-level difference in g moves the update by up to the
learning rate, and the atol is 2 * lr * steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mae_clip_tpu import config as jax_config
from mae_clip_tpu.models import clip as jax_clip
from mae_clip_tpu.models import distilbert as jax_distilbert
from mae_clip_tpu.models import vit as jax_vit
from mae_clip_tpu.ops import losses as jax_losses
from mae_clip_tpu.ops import masking as jax_masking
from mae_clip_tpu.train import loop as jax_loop
from mae_clip_tpu.train import optim as jax_optim
from mae_clip_tpu.train.state import TrainState as JaxTrainState
from mae_clip_torch import config as torch_config
from mae_clip_torch.interop.from_jax import state_dict_from_flax
from mae_clip_torch.models import CLIPModel, DistilBertConfig, ViTConfig
from mae_clip_torch.ops import losses as torch_losses
from mae_clip_torch.ops.masking import MaskingResult, random_masking
from mae_clip_torch.train import (TrainState, make_eval_step, make_optimizer,
                                  make_train_step, param_groups,
                                  precompute_text_features)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=1e-5, rtol=1e-3)
B = 4
TEXT = dict(vocab_size=50, dim=32, n_layers=2, n_heads=2, hidden_dim=64,
            max_position_embeddings=32)
VIT = dict(image_size=16, patch_size=8, dim=32, depth=2, n_heads=2)
CFG = dict(model_name="vit_s16", image_embedding=32, projection_dim=8,
           size=16, batch_size=B, compute_dtype="float32", dropout=0.0,
           gelu_impl="tanh", lr=1e-3)
MAE = dict(enabled=True, decoder_style="cross", mask_ratio=0.5,
           decoder_dim=32, decoder_depth=2, decoder_heads=2,
           decoder_attn_impl="pallas")
N_PATCHES = (16 // 8) ** 2


def _configs(**kw):
    mae = dict(MAE, **kw.pop("mae", {}))
    base = dict(CFG, **kw)
    return (jax_config.Config(**base, mae=jax_config.MAEConfig(**mae)),
            torch_config.Config(**base, mae=torch_config.MAEConfig(**mae)))


def _batch(seed=0, cached=True, padded=True):
    """uint8 patches, cached text features or tokens, a padded last row."""
    rng = np.random.default_rng(seed)
    batch = {"image": rng.integers(0, 256, (B, N_PATCHES, 192)).astype(
        np.uint8)}
    if cached:
        batch["text_features"] = rng.normal(size=(B, 32)).astype(np.float32)
    else:
        batch["input_ids"] = rng.integers(0, 50, (B, 9)).astype(np.int32)
        mask = np.ones((B, 9), np.int32)
        mask[1, 5:] = 0
        batch["attention_mask"] = mask
    if padded:
        batch["valid"] = np.array([True] * (B - 1) + [False])
    return batch


def _jax_masking(rng, step):
    """The masks JAX's train step draws at ``step``."""
    return jax_masking.random_masking(
        jax.random.fold_in(jax.random.fold_in(rng, step), 2), B, N_PATCHES,
        MAE["mask_ratio"])


def _torch_masking(m) -> MaskingResult:
    """JAX's int32 indices as int64 (what torch's gathers take)."""
    return MaskingResult(*(torch.tensor(np.asarray(x, np.float32)) if i == 2
                           else torch.tensor(np.asarray(x, np.int64))
                           for i, x in enumerate(m)))


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long()
            if k == "input_ids" else torch.from_numpy(np.asarray(v))
            for k, v in batch.items()}


def _jax_model(jcfg):
    return jax_clip.CLIPModel(
        jcfg, text_config=jax_distilbert.DistilBertConfig(**TEXT),
        vit_config=jax_vit.ViTConfig(**VIT), attn_impl="pallas_qkv",
        attn_interpret=True)


def _torch_model(tcfg, params):
    model = CLIPModel(tcfg, DistilBertConfig(**TEXT), ViTConfig(**VIT),
                      device="cpu")
    model.load_state_dict(state_dict_from_flax(
        params, tcfg, model.text_config, model.vit_config), strict=True)
    return model


def _seeded_params(jmodel, seed=0):
    """The JAX model's parameter tree (``jax.eval_shape`` of its ``init``:
    no compile) filled from a numpy seed: kernels normal / sqrt(fan_in),
    LayerNorm scales 1 + 0.1 * normal, biases, tables and tokens
    0.02 * normal (nonzero biases exercise more than zeros)."""
    rng = np.random.default_rng(seed)
    batch = {k: jnp.asarray(v) for k, v in _batch(cached=False).items()
             if k != "valid"}
    shapes = jax.eval_shape(lambda r: jmodel.init(
        r, batch, mask_rng=jax.random.PRNGKey(1)), jax.random.PRNGKey(0))

    def fill(path, leaf):
        name = str(path[-1].key)
        x = rng.normal(size=leaf.shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(leaf.shape[0])
        return 1.0 + 0.1 * x if name == "scale" else 0.02 * x

    return jax.tree_util.tree_map_with_path(fill, shapes["params"])


@pytest.fixture(scope="module")
def setup():
    """The JAX model and weights, shared by the tests of this file."""
    jcfg, tcfg = _configs()
    jmodel = _jax_model(jcfg)
    return jcfg, tcfg, jmodel, _seeded_params(jmodel)


@pytest.fixture(scope="module")
def grad_fn(setup):
    """jax.grad of the JAX loss (its train step's), with the forward's
    outputs: ``(grads, outputs)``, compiled once for the flagship batch."""
    jmodel = setup[2]

    def loss(p, batch, masking):
        out = _jax_forward(jmodel, p, batch, masking)
        return out["loss"], out

    return jax.jit(jax.grad(loss, has_aux=True))


def _jax_forward(jmodel, params, batch, masking):
    images = jax_loop._prep_images(jnp.asarray(batch["image"]), None, True,
                                   jmodel.cfg)
    jbatch = dict({k: jnp.asarray(v) for k, v in batch.items()},
                  image=images)
    return jmodel.apply({"params": params}, jbatch, train=True,
                        mae_masking=masking)


# ---------------------------------------------------------------------------
# Losses and masking
# ---------------------------------------------------------------------------

def test_clip_soft_ce_loss_matches_jax():
    """Value and gradients, with a padded row and a temperature != 1 (the
    /T on logits vs *T on targets asymmetry; targets not detached)."""
    rng = np.random.default_rng(0)
    img, txt = (rng.normal(size=(5, 6)).astype(np.float32) for _ in range(2))
    valid = np.array([True, True, False, True, True])
    for v in (None, valid):
        jv = None if v is None else jnp.asarray(v)
        want, want_g = jax.jit(jax.value_and_grad(
            lambda a, b: jax_losses.clip_soft_ce_loss(a, b, 0.7, jv),
            argnums=(0, 1)))(jnp.asarray(img), jnp.asarray(txt))
        ti, tt = (torch.from_numpy(x).requires_grad_() for x in (img, txt))
        got = torch_losses.clip_soft_ce_loss(
            ti, tt, 0.7, None if v is None else torch.from_numpy(v))
        got_g = torch.autograd.grad(got, (ti, tt))
        np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
        for x, y in zip(got_g, want_g):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), **GRAD_TOL)


@pytest.mark.parametrize("norm_pix", [True, False])
def test_mae_reconstruction_loss_matches_jax(norm_pix):
    rng = np.random.default_rng(1)
    pred, target = (rng.normal(size=(3, 5, 12)).astype(np.float32)
                    for _ in range(2))
    mask = (rng.random((3, 5)) > 0.5).astype(np.float32)
    want, want_g = jax.value_and_grad(
        lambda p: jax_losses.mae_reconstruction_loss(
            p, jnp.asarray(target), jnp.asarray(mask), norm_pix))(
                jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    got = torch_losses.mae_reconstruction_loss(
        tp, torch.from_numpy(target), torch.from_numpy(mask), norm_pix)
    (got_g,) = torch.autograd.grad(got, tp)
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **GRAD_TOL)


def test_cross_entropy_soft_matches_jax():
    rng = np.random.default_rng(2)
    preds = rng.normal(size=(4, 6)).astype(np.float32)
    targets = rng.dirichlet(np.ones(6), 4).astype(np.float32)
    for red in ("none", "mean"):
        np.testing.assert_allclose(
            torch_losses.cross_entropy_soft(
                torch.from_numpy(preds), torch.from_numpy(targets),
                red).numpy(),
            np.asarray(jax_losses.cross_entropy_soft(
                jnp.asarray(preds), jnp.asarray(targets), red)), **TOL)


@pytest.mark.parametrize("n,ratio", [(196, 0.75), (4, 0.5), (10, 0.3)])
def test_random_masking_invariants(n, ratio):
    """A fixed visible count int(N(1-r)); keep + masked is a permutation;
    ids_restore inverts it; the mask is 0 exactly at the kept patches."""
    m = random_masking(3, n, ratio, torch.Generator().manual_seed(0))
    keep = int(n * (1 - ratio))
    assert m.ids_keep.shape == (3, keep)
    assert m.ids_masked.shape == (3, n - keep)
    perm = torch.cat([m.ids_keep, m.ids_masked], dim=1)
    assert torch.equal(perm.sort(dim=1).values,
                       torch.arange(n).expand(3, n))
    assert torch.equal(torch.gather(perm, 1, m.ids_restore),
                       torch.arange(n).expand(3, n))
    assert torch.equal(m.mask.sum(1), torch.full((3,), float(n - keep)))
    assert float(torch.gather(m.mask, 1, m.ids_keep).abs().sum()) == 0.0
    again = random_masking(3, n, ratio, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(m, again))
    assert all(x.device.type == "cpu" for x in m)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host with no "
                    "CUDA card")
def test_random_masking_defaults_to_the_card():
    """Without a generator or a device the masks go to the card, as every
    entry point of the port does, and the call raises when there is none."""
    with pytest.raises(RuntimeError, match="no CUDA card"):
        random_masking(2, 16, 0.75)


# ---------------------------------------------------------------------------
# Model forward and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cached,from_masked", [(True, True),
                                                (False, False)])
def test_clip_forward_train_matches_jax(setup, grad_fn, cached,
                                       from_masked):
    """CLIPModel.forward(train=True): embeddings and losses, cached or inline
    (frozen) text, contrastive features from the masked or the full pass;
    and, in the flagship case (cached text, masked pass), MAEViT.forward
    (the masked pass + CrossMAE decoder) on its own. JAX's mask indices feed
    both sides; the flagship case's JAX forward is ``grad_fn``'s."""
    _, _, jmodel, params = setup
    jcfg, tcfg = _configs(mae=dict(clip_from_masked=from_masked))
    jm = jmodel.clone(cfg=jcfg)
    batch = _batch(4, cached=cached)
    masking = _jax_masking(jax.random.PRNGKey(6), 0)
    patches = np.random.default_rng(3).normal(
        size=(B, N_PATCHES, 192)).astype(np.float32)

    if cached:
        want = grad_fn(params, batch, masking)[1]
        want_mae = jax.jit(lambda p: jm.apply(
            {"params": p}, jnp.asarray(patches), None, masking=masking,
            method=lambda mod, x, r, masking: mod.image_encoder(
                x, r, masking=masking)))(params)
    else:
        want = jax.jit(lambda p: _jax_forward(jm, p, batch, masking))(params)
        want_mae = ()
    tmodel = _torch_model(tcfg, params)
    with torch.no_grad():
        got = tmodel(_prepped(_torch_batch(batch), tcfg), train=True,
                     masking=_torch_masking(masking))
        got_mae = tmodel.image_encoder(torch.from_numpy(patches),
                                       masking=_torch_masking(masking))
    assert tmodel.training and not tmodel.text_encoder.training
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL, err_msg=k)
    assert got_mae.pred_patches.shape == (B, 2, 192)
    assert len(want_mae) == (4 if cached else 0)
    for name, x, y in zip(got_mae._fields, got_mae, want_mae):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL,
                                   err_msg=name)


def _prepped(batch, cfg):
    from mae_clip_torch.train.loop import _prep_images
    return dict(batch, image=_prep_images(batch["image"], cfg))


def test_every_trainable_grad_matches_jax(setup, grad_fn):
    """The flagship path (cached text): every trainable parameter's gradient
    against jax.grad; the frozen text tower has none."""
    jcfg, tcfg, jmodel, params = setup
    batch = _batch(7)
    masking = _jax_masking(jax.random.PRNGKey(7), 0)
    want = state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray,
                               grad_fn(params, batch, masking)[0]),
        tcfg, DistilBertConfig(**TEXT), ViTConfig(**VIT))
    tmodel = _torch_model(tcfg, params)
    tmodel(_prepped(_torch_batch(batch), tcfg), train=True,
           masking=_torch_masking(masking))["loss"].backward()
    trainable = 0
    for name, p in tmodel.named_parameters():
        if name.startswith("text_encoder"):
            assert not p.requires_grad and p.grad is None, name
            continue
        trainable += 1
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   **GRAD_TOL, err_msg=name)
    assert trainable > 40


# ---------------------------------------------------------------------------
# The train step, the eval step, the text cache
# ---------------------------------------------------------------------------

def _assert_params_match(tmodel, jparams, small, tcfg, steps, got=None):
    """``small``: where a step's gradient was below 1e-6 in magnitude.
    ``got``: tensors by name to hold against the JAX tree's (default the
    model's state dict, every name)."""
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jparams),
                                tcfg, tmodel.text_config, tmodel.vit_config)
    if got is None:
        got = tmodel.state_dict()
    else:
        want = {name: want[name] for name in got}
    for name, w in want.items():
        atol = torch.where(small.get(name, torch.tensor(False)),
                           2 * tcfg.lr * steps, 1e-6)
        err = (got[name] - w).abs()
        bad = err > atol + 1e-5 * w.abs()
        assert not bool(bad.any()), (name, float(err.max()))


def test_train_steps_match_jax(setup):
    """One and two steps of make_train_step against JAX's jitted step: the
    metrics, and every parameter after each AdamW update (frozen text
    unchanged)."""
    jcfg, tcfg, jmodel, params = setup
    tx = jax_optim.make_optimizer(jcfg, params)
    rng0 = jax.random.PRNGKey(2)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.array, params),
                                  tx, jax.random.PRNGKey(2))  # donated
    jstep = jax_loop.make_train_step(jmodel, tx, jcfg)
    tmodel = _torch_model(tcfg, params)
    opt = make_optimizer(tcfg, tmodel)
    state = TrainState.create(tmodel, opt)
    step = make_train_step(tmodel, opt, tcfg)
    text_before = {k: v.clone() for k, v in tmodel.state_dict().items()
                   if k.startswith("text_encoder")}
    small = {}
    for i, batch in enumerate([_batch(8), _batch(9)]):
        masking = _jax_masking(rng0, i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tm = step(state, _torch_batch(batch), masking=_torch_masking(masking))
        for name, p in tmodel.named_parameters():   # this step's gradients
            if p.grad is not None:
                small[name] = small.get(name, False) | (p.grad.abs() < 1e-6)
        assert state.step == i + 1 == int(jstate.step)
        assert set(tm) == set(jm)
        for k in jm:
            assert tm[k].dim() == 0
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL,
                                       err_msg=k)
        _assert_params_match(tmodel, jstate.params, small, tcfg, i + 1)
    for k, v in text_before.items():
        assert torch.equal(tmodel.state_dict()[k], v), k


def test_siglip_lamb_cosine_clip_ema_steps_match_jax(setup):
    """Two steps of make_train_step with SigLIP (the logit scale and bias
    trained), LAMB, the cosine schedule (warmup 2: lr 0, then half the
    peak), clipping (active: the gradient norm is above 0.05) and EMA
    against JAX's jitted step: the metrics, every parameter and the EMA of
    every trainable one after each step. Then make_eval_step on the EMA
    weights against JAX's, and the live weights left as they were. The
    JAX model takes its XLA attention here (the kernels' parity is the
    other tests'), which traces and compiles in a fraction of the time."""
    jcfg, tcfg = _configs(contrastive_loss="siglip", optimizer="lamb",
                          lr_schedule="cosine", warmup_steps=2,
                          decay_steps=10, grad_clip_norm=0.05,
                          ema_decay=0.9, mae=dict(decoder_attn_impl="xla"))
    jmodel = setup[2].clone(cfg=jcfg, attn_impl="xla", attn_interpret=False)
    params = _with_logit(setup[3])
    tx = jax_optim.make_optimizer(jcfg, params)
    rng0 = jax.random.PRNGKey(4)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.array, params),
                                  tx, jax.random.PRNGKey(4), ema=True)
    jstep = jax_loop.make_train_step(jmodel, tx, jcfg)
    tmodel = _torch_model(tcfg, params)
    opt = make_optimizer(tcfg, tmodel)
    state = TrainState.create(tmodel, opt)
    step = make_train_step(tmodel, opt, tcfg)
    small = {}
    for i, batch in enumerate([_batch(13), _batch(14)]):
        masking = _jax_masking(rng0, i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tm = step(state, _torch_batch(batch), masking=_torch_masking(masking))
        grads = [p.grad for p in tmodel.parameters() if p.grad is not None]
        for name, p in tmodel.named_parameters():   # clipped gradients
            if p.grad is not None:
                small[name] = small.get(name, False) | (p.grad.abs() < 1e-6)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL,
                                       err_msg=k)
        _assert_params_match(tmodel, jstate.params, small, tcfg, i + 1)
        _assert_params_match(tmodel, jstate.ema_params, small, tcfg, i + 1,
                             got=state.ema)
    assert float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads]))) == pytest.approx(
            0.05, rel=1e-4)                              # clipped
    assert float(tmodel.logit_bias.detach()) != -10.0
    batch = _batch(15)
    live = {k: v.clone() for k, v in tmodel.state_dict().items()}
    want = jax_loop.make_eval_step(jmodel, jcfg)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_eval_step(tmodel, tcfg)(state, _torch_batch(batch),
                                       masking=_torch_masking(
                                           _jax_masking(rng0, 2)))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), **TOL,
                                   err_msg=k)
    assert all(torch.equal(v, live[k]) for k, v in tmodel.state_dict().items())


def test_eval_step_matches_jax(setup):
    jcfg, tcfg, jmodel, params = setup
    tx = jax_optim.make_optimizer(jcfg, params)
    rng0 = jax.random.PRNGKey(3)
    jstate = JaxTrainState.create(params, tx, rng0)
    batch = _batch(10)
    want = jax_loop.make_eval_step(jmodel, jcfg)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tmodel = _torch_model(tcfg, params)
    state = TrainState.create(tmodel, make_optimizer(tcfg, tmodel))
    got = make_eval_step(tmodel, tcfg)(state, _torch_batch(batch),
                                       masking=_torch_masking(
                                           _jax_masking(rng0, 0)))
    assert not tmodel.training
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), **TOL,
                                   err_msg=k)


def test_precompute_text_features_matches_jax(setup):
    """The frozen-text cache, with a ragged last batch."""
    jcfg, tcfg, jmodel, params = setup

    @dataclasses.dataclass
    class Captions:
        input_ids: np.ndarray
        attention_mask: np.ndarray

        def __len__(self):
            return len(self.input_ids)

    rng = np.random.default_rng(11)
    mask = np.ones((5, 7), np.int32)
    mask[2, 3:] = 0
    data = Captions(rng.integers(0, 50, (5, 7)).astype(np.int32), mask)
    want = jax_loop.precompute_text_features(jmodel, {"params": params},
                                             data, batch_size=4)
    got = precompute_text_features(_torch_model(tcfg, params), data,
                                   batch_size=4)
    assert got.shape == (5, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


def test_optimizer_groups_match_jax_labels(setup):
    """Labels from name prefixes as the JAX label tree; AdamW groups with
    the py recipe's lr / weight decay; frozen params in no group."""
    jcfg, tcfg, _, params = setup
    scfg = tcfg.replace(contrastive_loss="siglip")
    pw = _with_logit(params)
    tmodel = _torch_model(scfg, pw)
    labels = param_groups(scfg, tmodel)
    names = ["head", "image", "text", "logit", "frozen"]
    jlabels = state_dict_from_flax(jax.tree_util.tree_map(
        lambda lab, p: np.full(np.shape(p), names.index(lab), np.float32),
        jax_optim.param_groups(jcfg, pw), pw), scfg, tmodel.text_config,
        tmodel.vit_config)
    for name, label in labels.items():
        assert label == names[int(jlabels[name].flatten()[0])], name
    assert labels["logit_scale"] == "logit"
    assert labels["image_projection.fc.weight"] == "head"
    opt = make_optimizer(scfg, tmodel)
    by_name = {g["name"]: g for g in opt.param_groups}
    assert set(by_name) == {"head", "image", "logit"}
    assert by_name["logit"]["weight_decay"] == 0.0
    assert by_name["image"]["weight_decay"] == tcfg.weight_decay > 0
    n_opt = sum(len(g["params"]) for g in opt.param_groups)
    assert n_opt == sum(p.requires_grad for p in tmodel.parameters())


def _with_logit(params):
    return dict(params, logit_scale=np.float32(2.3),
                logit_bias=np.float32(-10.0))


def test_unported_options_raise(setup):
    """The ResNet50 tower is ported: a ResNet CLIP builds on the CPU (the
    full tower, 2048-d into the image head). uint8 sources at another size
    are cropped in the step, and text caching needs a frozen eval-mode
    tower."""
    _, tcfg, _, params = setup
    tmodel = _torch_model(tcfg, params)
    opt = make_optimizer(tcfg, tmodel)
    resnet = CLIPModel(tcfg.replace(model_name="resnet50",
                                    mae=torch_config.MAEConfig()),
                       DistilBertConfig(**TEXT), device="cpu")
    assert resnet.image_projection.projection.weight.shape == (8, 2048)
    state = TrainState.create(tmodel, opt)
    # uint8 sources at another size than cfg.size are now cropped in the
    # step (ops/augment.py) instead of raising.
    big = {"image": np.zeros((B, 32, 32, 3), np.uint8),
           "text_features": np.zeros((B, 32), np.float32)}
    metrics = make_train_step(tmodel, opt, tcfg)(state, big)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    with pytest.raises(ValueError, match="frozen"):
        precompute_text_features(
            _torch_model(tcfg.replace(frozen_text_eval_mode=False), params),
            None)


@pytest.mark.parametrize("kw", [
    dict(optimizer="lamb"), dict(optimizer="lion"),
    dict(lr_schedule="cosine", warmup_steps=1, decay_steps=10),
    dict(grad_clip_norm=1.0),
    dict(contrastive_loss="siglip"),
    dict(contrastive_loss="clip"),
    dict(contrastive_loss="clip", learnable_temperature=True),
    dict(learnable_temperature=True),
    dict(ema_decay=0.99), dict(ema_decay=0.99, ema_eval=False),
    dict(text_trainable=True),   # attention_dropout 0.1 in train mode
    dict(loss_chunk_size=4),
    dict(contrastive_loss="clip", loss_chunk_size=4),
    dict(remat=True),
    dict(accum_steps=2),
    dict(accum_steps=2, true_global_contrastive=False),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_ported_options_run(kw):
    """Each option that raised before it was ported runs a train step and
    an eval step with finite metrics. A trained text tower reads tokens
    with a padding mask, its attention dropout on. The learnable
    temperature's scale starts above log(100) and is clamped after the
    update; with ema_eval the eval reads the EMA (a live weight set to NaN
    leaves it finite), without it the live weights. ``accum_steps`` runs
    GradCache, or the per-microbatch loss without
    ``true_global_contrastive``."""
    kw = dict(kw)
    step_kw = {k: kw.pop(k) for k in ("true_global_contrastive",) if k in kw}
    _, tcfg = _configs(**kw)
    model = CLIPModel(tcfg, DistilBertConfig(**TEXT), ViTConfig(**VIT),
                      device="cpu").init_weights(torch.Generator()
                                                 .manual_seed(0))
    if tcfg.learnable_temperature:
        with torch.no_grad():
            model.logit_scale.fill_(5.0)
    opt = make_optimizer(tcfg, model)
    state = TrainState.create(model, opt)
    batch = _torch_batch(_batch(12, cached=not tcfg.text_trainable))
    metrics = make_train_step(model, opt, tcfg, accum_steps=tcfg.accum_steps,
                              **step_kw)(state, batch)
    assert state.step == 1
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    if tcfg.learnable_temperature:
        assert float(model.logit_scale.detach()) == pytest.approx(np.log(100.0))
    if tcfg.text_trainable:
        assert model.text_encoder.model.embeddings.word_embeddings \
            .weight.grad is not None
    assert (state.ema is not None) == (tcfg.ema_decay > 0)
    if state.ema is not None:
        assert set(state.ema) == {n for n, p in model.named_parameters()
                                  if p.requires_grad}
        with torch.no_grad():
            model.image_projection.fc.weight.fill_(float("nan"))
    evaluated = make_eval_step(model, tcfg)(state, batch)
    finite = all(bool(torch.isfinite(v)) for v in evaluated.values())
    assert finite == (tcfg.ema_decay == 0 or tcfg.ema_eval)
