"""The 32k-batch recipe's mechanisms in the port against the JAX package.

The one-device chunked losses against JAX's chunked global losses under
``shard_map`` on a 1-device mesh (the JAX step's route for
``loss_chunk_size > 0`` on one chip); GradCache and the per-microbatch
(legacy) accumulation against JAX's ``make_train_step(accum_steps=4)``
with plain SGD, so the update is the gradient; GradCache against the
port's own accum-1 step (the whole-batch mask draw, the loss-only
parameters' gradients); the mean-of-means MAE loss that JAX's GradCache
takes when padded rows are not spread evenly over the microbatches; and
per-block remat against no remat, a trained text tower's dropout included.

The model is ``tests/test_torch_train.py``'s (widths 32, two layers,
16x16 images, patch 8) with the MAE-paper ``'full'`` decoder of
``large_batch_mesh_config``, dropout 0, fp32 on the CPU; the JAX side
takes its XLA attention (the kernels' parity is other tests'). The MAE
masks come from JAX's ``random_masking`` as each JAX step draws them.
Tolerances: the losses' values rtol 1e-5, their gradients 1e-5 of each
tensor's largest entry; the steps' metrics rtol 2e-6 (as the JAX package's
own GradCache tests), parameters after two SGD(1) steps within 1e-5 +
1e-5 |x|, GradCache's gradients against the accum-1 step's within 1e-5
of each tensor's largest entry; remat against no remat 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from mae_clip_tpu import config as jax_config
from mae_clip_tpu.models import clip as jax_clip
from mae_clip_tpu.models import distilbert as jax_distilbert
from mae_clip_tpu.models import vit as jax_vit
from mae_clip_tpu.ops import losses as jax_losses
from mae_clip_tpu.ops import masking as jax_masking
from mae_clip_tpu.train import loop as jax_loop
from mae_clip_tpu.train.state import TrainState as JaxTrainState
from mae_clip_torch import config as torch_config
from mae_clip_torch.interop.from_jax import state_dict_from_flax
from mae_clip_torch.models import CLIPModel, DistilBertConfig, ViTConfig
from mae_clip_torch.ops import losses as torch_losses
from mae_clip_torch.ops.masking import MaskingResult
from mae_clip_torch.train import TrainState, make_train_step
from test_torch_train import TEXT, VIT, _seeded_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, K = 8, 4                    # batch, microbatches
N_PATCHES = (16 // 8) ** 2
CFG = dict(model_name="vit_s16", image_embedding=32, projection_dim=8,
           size=16, batch_size=B, compute_dtype="float32", dropout=0.0,
           gelu_impl="tanh", lr=1e-3)
MAE = dict(enabled=True, decoder_style="full", mask_ratio=0.5,
           decoder_dim=32, decoder_depth=2, decoder_heads=2,
           decoder_attn_impl="xla")
RTOL = 1e-5


def _configs(**kw):
    mae = dict(MAE, **kw.pop("mae", {}))
    base = dict(CFG, **kw)
    return (jax_config.Config(**base, mae=jax_config.MAEConfig(**mae)),
            torch_config.Config(**base, mae=torch_config.MAEConfig(**mae)))


def _batch(seed, padded_row=B - 1):
    """uint8 patches, cached text features, one padded row."""
    rng = np.random.default_rng(seed)
    valid = np.ones(B, bool)
    valid[padded_row] = False
    return {"image": rng.integers(0, 256, (B, N_PATCHES, 192)).astype(
                np.uint8),
            "text_features": rng.normal(size=(B, 32)).astype(np.float32),
            "valid": valid}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _torch_masking(m) -> MaskingResult:
    return MaskingResult(*(torch.tensor(np.asarray(x, np.float32)) if i == 2
                           else torch.tensor(np.asarray(x, np.int64))
                           for i, x in enumerate(m)))


def _jax_step_masking(rng, step, legacy):
    """The masks JAX's accumulating step draws at ``step``: once for the
    whole batch (GradCache), or per microbatch from the microbatch's key
    (legacy), concatenated."""
    key = jax.random.fold_in(rng, step)
    if not legacy:
        return jax_masking.random_masking(jax.random.fold_in(key, 2), B,
                                          N_PATCHES, MAE["mask_ratio"])
    parts = [jax_masking.random_masking(
        jax.random.fold_in(jax.random.fold_in(key, i), 2), B // K,
        N_PATCHES, MAE["mask_ratio"]) for i in range(K)]
    return tuple(jnp.concatenate(xs) for xs in zip(*parts))


@pytest.fixture(scope="module")
def jax_setup():
    jcfg, tcfg = _configs()
    jmodel = jax_clip.CLIPModel(
        jcfg, text_config=jax_distilbert.DistilBertConfig(**TEXT),
        vit_config=jax_vit.ViTConfig(**VIT), attn_impl="xla")
    return jcfg, tcfg, jmodel, _seeded_params(jmodel)


def _torch_model(tcfg, params, **kw):
    model = CLIPModel(tcfg.replace(**kw), DistilBertConfig(**TEXT),
                      ViTConfig(**VIT), device="cpu")
    model.load_state_dict(state_dict_from_flax(
        params, tcfg, model.text_config, model.vit_config), strict=True)
    return model


def _sgd_state(model):
    """SGD(lr=1) over the trainable parameters: the update is the
    gradient."""
    opt = torch.optim.SGD([p for p in model.parameters() if p.requires_grad],
                          lr=1.0)
    return opt, TrainState.create(model, opt)


# ---------------------------------------------------------------------------
# (i) The chunked losses
# ---------------------------------------------------------------------------

def _jax_chunked_loss(hard: bool, chunk: int):
    """JAX's chunked global loss on a 1-device mesh with the temperature
    of a learnable log-scale: value and gradients in (img, txt, scale)."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    fn = (jax_losses.global_clip_hard_ce_loss if hard
          else jax_losses.global_clip_soft_ce_loss_chunked)

    def loss(img, txt, scale, valid):
        t = jax_losses.temperature_of(scale)
        return shard_map(
            lambda i, tx, v, u: fn(i, tx, temperature=u, valid=v,
                                   axis_name="data", chunk_size=chunk),
            mesh=mesh, in_specs=(P("data"), P("data"), P("data"), P()),
            out_specs=P())(img, txt, valid, t)

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
@pytest.mark.parametrize("chunk", [4, 3], ids=["divides", "ragged"])
def test_chunked_losses_match_jax(hard, chunk):
    """The one-device chunked soft and hard losses against JAX's chunked
    global losses on a 1-device mesh: 10 rows (the last padded) in blocks
    of 4 or 3 columns, the temperature from a learnable log-scale; the
    value and the gradients in both embeddings and the scale. The port's
    unchunked loss agrees too."""
    rng = np.random.default_rng(20 + chunk)
    img, txt = (rng.normal(size=(10, 6)).astype(np.float32)
                for _ in range(2))
    valid = np.ones(10, bool)
    valid[-1] = False
    scale = np.float32(0.3)
    want, want_g = _jax_chunked_loss(hard, chunk)(
        jnp.asarray(img), jnp.asarray(txt), jnp.asarray(scale),
        jnp.asarray(valid))
    chunked = (torch_losses.clip_hard_ce_loss_chunked if hard
               else torch_losses.clip_soft_ce_loss_chunked)
    plain = (torch_losses.clip_hard_ce_loss if hard
             else torch_losses.clip_soft_ce_loss)
    for fn in (lambda *a: chunked(*a, chunk_size=chunk), plain):
        ti, tt = (torch.from_numpy(x).requires_grad_() for x in (img, txt))
        ts = torch.tensor(scale, requires_grad=True)
        got = fn(ti, tt, torch_losses.temperature_of(ts),
                 torch.from_numpy(valid))
        got_g = torch.autograd.grad(got, (ti, tt, ts))
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=RTOL)
        for x, y in zip(got_g, want_g):   # relative to the largest entry
            y = np.asarray(y)
            np.testing.assert_allclose(x.numpy(), y, rtol=RTOL,
                                       atol=RTOL * np.abs(y).max())


def test_chunked_soft_loss_stays_finite_where_jax_gives_nan():
    """A difference kept from the reference (its fault): at width 256 a
    padded row's own similarity (~256) exceeds its normaliser over the
    valid columns by more than fp32's exp range. JAX's chunked soft loss
    masks padded columns after the exponential, so its gradients are NaN;
    the port masks before it and matches JAX's unchunked loss."""
    rng = np.random.default_rng(24)
    img, txt = (rng.normal(size=(64, 256)).astype(np.float32)
                for _ in range(2))
    valid = np.ones(64, bool)
    valid[[3, 40]] = False
    args = (jnp.asarray(img), jnp.asarray(txt), jnp.float32(0.0),
            jnp.asarray(valid))
    _, jax_chunked_g = _jax_chunked_loss(False, 16)(*args)
    assert all(bool(np.isnan(np.asarray(g)).any())
               for g in jax_chunked_g[:2])
    want, want_g = jax.jit(jax.value_and_grad(
        lambda i, t, s, v: jax_losses.clip_soft_ce_loss(
            i, t, jax_losses.temperature_of(s), v), argnums=(0, 1)))(*args)
    ti, tt = (torch.from_numpy(x).requires_grad_() for x in (img, txt))
    got = torch_losses.clip_soft_ce_loss_chunked(ti, tt, 1.0,
                                                 torch.from_numpy(valid), 16)
    got_g = torch.autograd.grad(got, (ti, tt))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    for x, y in zip(got_g, want_g):
        y = np.asarray(y)
        np.testing.assert_allclose(x.numpy(), y, rtol=RTOL,
                                   atol=RTOL * np.abs(y).max())


# ---------------------------------------------------------------------------
# (ii), (v) GradCache and the legacy mode against JAX's accumulating step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def accum_runs(jax_setup):
    """Two steps of JAX's and the port's accumulating steps (accum 4, SGD
    lr 1) on the same weights and masks, for both modes; the padded row
    lies in the last microbatch alone. Returns per mode the metrics of
    each step on both sides and both sides' parameters at the end."""
    jcfg, tcfg, jmodel, params = jax_setup
    runs = {}
    for legacy in (False, True):
        tx = optax.sgd(1.0)
        rng0 = jax.random.PRNGKey(5)
        jstate = JaxTrainState.create(      # donated by the step
            jax.tree_util.tree_map(jnp.array, params), tx,
            jax.random.PRNGKey(5))
        jstep = jax_loop.make_train_step(jmodel, tx, jcfg, accum_steps=K,
                                         true_global_contrastive=not legacy)
        model = _torch_model(tcfg, params)
        opt, state = _sgd_state(model)
        step = make_train_step(model, opt, tcfg, accum_steps=K,
                               true_global_contrastive=not legacy)
        metrics = []
        for i, batch in enumerate([_batch(30), _batch(31)]):
            jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
            tm = step(state, _torch_batch(batch), masking=_torch_masking(
                _jax_step_masking(rng0, i, legacy)))
            metrics.append(({k: float(v) for k, v in tm.items()},
                            {k: float(v) for k, v in jm.items()}))
        runs["legacy" if legacy else "gradcache"] = dict(
            metrics=metrics, model=model, tcfg=tcfg,
            jparams=jax.tree_util.tree_map(np.asarray, jstate.params))
    return runs


@pytest.mark.parametrize("mode", ["gradcache", "legacy"])
def test_accumulating_steps_match_jax(accum_runs, mode):
    """GradCache and the legacy mode at accum 4 against JAX's, two steps
    of SGD(1): every metric (rtol 2e-6) and every parameter (within 1e-5 +
    1e-5 |x|: the class token's gradient sums every row's and reaches 10
    here)."""
    run = accum_runs[mode]
    for got, want in run["metrics"]:
        assert set(got) == set(want) == {"clip_loss", "mae_loss", "loss"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-6,
                                       err_msg=f"{mode} {k}")
    model = run["model"]
    want = state_dict_from_flax(run["jparams"], run["tcfg"],
                                model.text_config, model.vit_config)
    got = model.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_gradcache_mae_loss_is_the_mean_of_microbatch_means(accum_runs,
                                                           jax_setup):
    """JAX's GradCache takes the MAE loss as the mean of the microbatch
    means; with the padded row in one microbatch only, the denominators
    differ and that is not the whole batch's mean (a difference kept from
    the reference). The port follows JAX, and the accum-1 step, on the
    same weights and masks, gives the whole batch's mean."""
    _, tcfg, _, params = jax_setup
    got, want = accum_runs["gradcache"]["metrics"][0]
    np.testing.assert_allclose(got["mae_loss"], want["mae_loss"], rtol=2e-6)
    model = _torch_model(tcfg, params)
    opt, state = _sgd_state(model)
    whole = make_train_step(model, opt, tcfg)(
        state, _torch_batch(_batch(30)), masking=_torch_masking(
            _jax_step_masking(jax.random.PRNGKey(5), 0, False)))
    gap = abs(float(whole["mae_loss"]) - got["mae_loss"])
    assert gap > 1e-3 * abs(got["mae_loss"]), (float(whole["mae_loss"]),
                                               got["mae_loss"])
    # clip_loss is the whole batch's in both.
    np.testing.assert_allclose(float(whole["clip_loss"]), got["clip_loss"],
                               rtol=2e-6)


# ---------------------------------------------------------------------------
# (iii), (iv) GradCache against the port's own accum-1 and legacy steps
# ---------------------------------------------------------------------------

def _step_grads(tcfg, params, accum, batch, legacy=False, **kw):
    """One step of SGD(1) from ``params`` with the masks drawn by the step
    from seed 0; the metrics and every trainable gradient."""
    model = _torch_model(tcfg, params, **kw)
    opt, state = _sgd_state(model)
    metrics = make_train_step(model, opt, model.cfg, accum_steps=accum,
                              true_global_contrastive=not legacy)(
                                  state, _torch_batch(batch))
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None})


@pytest.mark.parametrize("kw", [
    dict(),
    dict(contrastive_loss="clip", learnable_temperature=True),
    dict(contrastive_loss="siglip"),
], ids=["soft", "clip+learnable_t", "siglip"])
def test_gradcache_matches_own_giant_batch_step(jax_setup, kw):
    """GradCache at accum 4 against the accum-1 step from the same seed,
    masks drawn by the steps (GradCache draws the whole batch's once, as
    the accum-1 model does): the metrics, and every gradient, the loss-only
    ``logit_scale`` / ``logit_bias`` included (theirs come from the loss
    pass alone). All rows valid: the MAE mean of means is the whole
    batch's only then."""
    _, tcfg, _, params = jax_setup
    if kw.get("contrastive_loss") == "siglip" or kw.get(
            "learnable_temperature"):
        params = dict(params, logit_scale=np.float32(2.3),
                      logit_bias=np.float32(-10.0))
        if kw.get("learnable_temperature"):
            params.pop("logit_bias")
    batch = dict(_batch(40), valid=np.ones(B, bool))
    tcfg = tcfg.replace(**kw)
    whole, g_whole = _step_grads(tcfg, params, 1, batch)
    acc, g_acc = _step_grads(tcfg, params, K, batch)
    for k in whole:
        np.testing.assert_allclose(acc[k], whole[k], rtol=2e-6, err_msg=k)
    assert set(g_acc) == set(g_whole)
    assert {"logit_scale", "logit_bias"} & set(g_whole) == (
        {n for n in ("logit_scale", "logit_bias") if n in params})
    for n, g in g_whole.items():   # relative to the largest entry
        np.testing.assert_allclose(g_acc[n].numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(g.abs().max()),
                                   err_msg=n)


def test_gradcache_loss_differs_from_legacy(jax_setup):
    """The legacy mode's contrastive batch is the microbatch, a different
    objective: its loss must not equal GradCache's (GradCache must not
    fall back to it)."""
    _, tcfg, _, params = jax_setup
    batch = _batch(41)
    gc, _ = _step_grads(tcfg, params, K, batch)
    legacy, _ = _step_grads(tcfg, params, K, batch, legacy=True)
    assert abs(gc["clip_loss"] - legacy["clip_loss"]) > 1e-2, (gc, legacy)


# ---------------------------------------------------------------------------
# (vi) Remat
# ---------------------------------------------------------------------------

def _count_block_calls(model) -> dict:
    """Calls of each transformer block of ``model``, by name, counted by
    forward pre-hooks: remat's recompute in the backward calls a block
    again (and stops it once the saved tensors are back, so a hook after
    the forward would miss it)."""
    calls = {}
    for name, mod in model.named_modules():
        if type(mod).__name__ in ("ViTBlock", "TransformerBlock"):
            calls[name] = 0
            mod.register_forward_pre_hook(
                lambda m, a, n=name: calls.__setitem__(n, calls[n] + 1))
    return calls


@pytest.mark.parametrize("case", ["encoder", "full", "cross", "text"])
def test_remat_matches_no_remat(case):
    """``remat=True`` against ``remat=False`` from the same weights and
    seeds, within 1e-6: the CLIP step without MAE (the ViT encoder), with
    the 'full' and the 'cross' decoder, and with a trained text tower on
    tokens whose dropout and attention dropout (0.1) are on: remat's
    recompute must draw the same dropout masks as the first forward. With
    remat the image encoder's blocks (and the trained text tower's) run
    twice a step, the MAE decoder's once (as JAX's); without it, each
    block that runs runs once."""
    kw, batch = {}, _batch(50)
    if case == "encoder":
        kw["mae"] = dict(enabled=False)
    elif case == "cross":
        kw["mae"] = dict(decoder_style="cross")
    elif case == "text":
        kw["text_trainable"] = True
        rng = np.random.default_rng(51)
        batch.pop("text_features")
        batch["input_ids"] = rng.integers(0, 50, (B, 9)).astype(np.int64)
        batch["attention_mask"] = np.ones((B, 9), np.int64)
        batch["attention_mask"][1, 5:] = 0
    runs = []
    for remat in (False, True):
        tcfg = _configs(**kw)[1].replace(remat=remat)
        model = CLIPModel(tcfg, DistilBertConfig(**TEXT), ViTConfig(**VIT),
                          device="cpu").init_weights(
                              torch.Generator().manual_seed(0))
        opt, state = _sgd_state(model)
        calls = _count_block_calls(model)
        torch.manual_seed(7)
        metrics = make_train_step(model, opt, tcfg)(state,
                                                    _torch_batch(batch))
        ran = {n for n in calls if case == "text"
               or not n.startswith("text_encoder.")}
        again = {n for n in ran if remat and n.startswith(
            ("image_encoder.blocks.", "text_encoder."))}
        assert again or not remat
        assert calls == {n: (n in ran) + (n in again) for n in calls}, calls
        runs.append(({k: float(v) for k, v in metrics.items()},
                     {n: p.grad for n, p in model.named_parameters()
                      if p.grad is not None}))
    (m0, g0), (m1, g1) = runs
    for k in m0:
        np.testing.assert_allclose(m1[k], m0[k], rtol=1e-6, err_msg=k)
    assert set(g0) == set(g1)
    if case == "text":
        assert any(n.startswith("text_encoder") for n in g0)
    for n, g in g0.items():
        np.testing.assert_allclose(g1[n].numpy(), g.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=n)
