"""The port's fused block stacks (mae_clip_torch.ops.block_kernel and the
``fused_blocks`` paths of the models) against the JAX package's.

Kernel level: the plain versions of kernels #6 and #7 (what the wrappers run
on the CPU) against JAX's ``fused_block_stack`` with its Pallas kernels in
interpret mode, at the smallest legal width (D=128, one head of 128, F=256,
two blocks, B=2) with Sq=9 and Sk=5, so that JAX pads both and masks the
padded keys. Weights and inputs come from a numpy seed; JAX's ``(in, out)``
matrices go through ``block_stack_weights_from_jax``. fp32: values atol
2e-5 / rtol 1e-4, dq0 and dkv 5e-4 / 1e-3, each weight gradient 2e-5 after
dividing by its largest magnitude (JAX's own ``test_block_kernel.py``
tolerances); bf16 values within 2e-2 * max(1, max |JAX|).

Model level: the port's ``MAEViT`` (cross decoder) with ``block_impl='on'``
on the CPU against JAX's per-block ``'off'`` model (plain XLA) on the same
converted weights and masks, as JAX's ``test_mae_cross_decoder_fused_matches_xla``
holds its own fused path: pooled and pred atol 2e-5 / rtol 1e-4, gradients
of the reconstruction loss 1e-4 / 1e-3; ``encode_full`` likewise. Then one
CLIP training step with ``fused_blocks='on'`` and with ``'fwd'`` against
JAX's step: the metrics and every parameter after the AdamW update, as
``test_torch_train.py`` holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mae_clip_tpu import config as jax_config
from mae_clip_tpu.models import clip as jax_clip
from mae_clip_tpu.models import distilbert as jax_distilbert
from mae_clip_tpu.models import mae as jax_mae
from mae_clip_tpu.models import vit as jax_vit
from mae_clip_tpu.ops import block_kernel as jax_bk
from mae_clip_tpu.ops import losses as jax_losses
from mae_clip_tpu.ops import masking as jax_masking
from mae_clip_tpu.train import loop as jax_loop
from mae_clip_tpu.train import optim as jax_optim
from mae_clip_tpu.train.state import TrainState as JaxTrainState
from mae_clip_torch import config as torch_config
from mae_clip_torch.interop import from_jax
from mae_clip_torch.models import (CLIPModel, DistilBertConfig, MAEViT,
                                   ViTConfig)
from mae_clip_torch.models.mae import MAEDecoderConfig
from mae_clip_torch.ops import block_kernel as BK
from mae_clip_torch.ops.losses import mae_reconstruction_loss
from mae_clip_torch.ops.masking import MaskingResult
from mae_clip_torch.train import TrainState, make_optimizer, make_train_step
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

L, B, SQ, SK, D, F, H = 2, 2, 9, 5, 128, 256, 1
VAL_TOL = dict(atol=2e-5, rtol=1e-4)
DX_TOL = dict(atol=5e-4, rtol=1e-3)


def _stack_weights(seed):
    """JAX-layout stacked weights, numpy fp32 (as ``test_block_kernel``)."""
    rng = np.random.default_rng(seed)

    def s(*shape):
        return (rng.normal(size=shape) * 0.05).astype(np.float32)

    return {"ln1_g": 1 + s(L, D), "ln1_b": s(L, D), "lnkv_g": 1 + s(L, D),
            "lnkv_b": s(L, D), "wq": s(L, D, D), "bq": s(L, D),
            "wkv": s(L, D, 2 * D), "bkv": s(L, 2 * D), "wproj": s(L, D, D),
            "bproj": s(L, D), "ln2_g": 1 + s(L, D), "ln2_b": s(L, D),
            "wfc1": s(L, D, F), "bfc1": s(L, F), "wfc2": s(L, F, D),
            "bfc2": s(L, D)}


def _port_grad(g):
    """A JAX weight gradient in the port's layout."""
    g = np.asarray(g)
    return np.swapaxes(g, 1, 2) if g.ndim == 3 else g


@pytest.fixture(scope="module", params=[True, False], ids=["cross", "self"])
def stack_case(request):
    """Inputs and JAX's answers for one mode, one jit: the fp32 value and
    the gradients of sum(sin(out)) through ``fused_block_stack``'s backward
    rule and through ``fused_block_stack_fwd_xla_bwd``'s, and the bf16
    value."""
    cross = request.param
    rng = np.random.default_rng(3)
    w = _stack_weights(4)
    q0 = rng.normal(size=(B, SQ, D)).astype(np.float32)
    kv = rng.normal(size=(B, SK, D)).astype(np.float32)

    def jax_side(q, k, ww):
        # One forward for both backward rules: the loss sum(sin(out)) sends
        # cos(out) into _fbs_bwd (the Pallas backward) and _fbsx_bwd (the
        # XLA recompute backward of fused_block_stack_fwd_xla_bwd).
        k = k if cross else q
        out, qstack = jax_bk._stack_forward(q, k, ww, H, "tanh", cross, True)
        dout = jnp.cos(out)
        g = jax_bk._fbs_bwd(H, "tanh", cross, True, (qstack, k, ww), dout)
        qs = qstack.reshape(L, B, -1, D)[:, :, :SQ, :]
        gx = jax_bk._fbsx_bwd(H, "tanh", cross, True, (qs, k, ww), dout)
        wb = {n: v.astype(jnp.bfloat16) for n, v in ww.items()}
        out16, _ = jax_bk._stack_forward(
            q.astype(jnp.bfloat16), k.astype(jnp.bfloat16), wb, H, "tanh",
            cross, True)
        return out, g, gx, out16.astype(jnp.float32)

    out, g, gx, out16 = jax.jit(jax_side)(
        jnp.asarray(q0), jnp.asarray(kv), {k: jnp.asarray(v)
                                           for k, v in w.items()})
    return dict(cross=cross, w=w, q0=q0, kv=kv, out=np.asarray(out), g=g,
                gx=gx, out16=np.asarray(out16))


def _port_grads(fn, case):
    cross = case["cross"]
    w = {k: v.requires_grad_() for k, v in
         from_jax.block_stack_weights_from_jax(case["w"]).items()}
    q0 = torch.from_numpy(case["q0"]).requires_grad_()
    kv = torch.from_numpy(case["kv"]).requires_grad_() if cross else q0
    out = fn(q0, kv, w, H, "tanh", cross)
    torch.sin(out).sum().backward()
    return out.detach().numpy(), q0.grad, kv.grad, {k: v.grad
                                                    for k, v in w.items()}


def _assert_grads(got, want, cross):
    _, dq0, dkv, dw = got
    np.testing.assert_allclose(dq0.numpy(), np.asarray(want[0]), **DX_TOL)
    if cross:
        np.testing.assert_allclose(dkv.numpy(), np.asarray(want[1]),
                                   **DX_TOL)
    for k in BK.W_KEYS:
        ref = _port_grad(want[2][k])
        scale = float(np.abs(ref).max()) + 1e-9
        np.testing.assert_allclose(dw[k].numpy() / scale, ref / scale,
                                   atol=2e-5, err_msg=k)


def test_plain_stack_matches_jax_kernel_fp32(stack_case):
    """The plain #6 and #7 (the autograd Function on the CPU) against JAX's
    Pallas kernels in interpret mode: value and every gradient."""
    before = (BK.fused_block_stack.launches,
              BK.fused_block_stack.bwd_launches)
    got = _port_grads(BK.fused_block_stack, stack_case)
    np.testing.assert_allclose(got[0], stack_case["out"], **VAL_TOL)
    _assert_grads(got, stack_case["g"], stack_case["cross"])
    assert (BK.fused_block_stack.launches,
            BK.fused_block_stack.bwd_launches) == before
    if not stack_case["cross"]:
        assert torch.equal(got[3]["lnkv_g"], torch.zeros(L, D))


def test_plain_stack_matches_jax_kernel_bf16(stack_case):
    """bf16 values: the plain #6 with the kernels' roundings against JAX's
    Pallas kernel, within 2e-2 * max(1, max |JAX|)."""
    cross = stack_case["cross"]
    w = {k: v.to(torch.bfloat16) for k, v in
         from_jax.block_stack_weights_from_jax(stack_case["w"]).items()}
    q0 = torch.from_numpy(stack_case["q0"]).to(torch.bfloat16)
    kv = torch.from_numpy(stack_case["kv"]).to(torch.bfloat16)
    out, qstack = BK.fused_block_stack_ref(q0, kv if cross else q0, w, H,
                                           "tanh", cross)
    want = stack_case["out16"]
    assert out.dtype == torch.bfloat16 and qstack.shape == (L, B, SQ, D)
    assert torch.equal(qstack[0], q0)
    np.testing.assert_allclose(out.float().numpy(), want, rtol=0,
                               atol=2e-2 * max(1.0, np.abs(want).max()))


def test_fwd_plain_bwd_matches_jax_fwd_xla_bwd(stack_case):
    """'fwd': #6 forward with the per-block plain recompute backward,
    against JAX's fused_block_stack_fwd_xla_bwd."""
    got = _port_grads(BK.fused_block_stack_fwd_plain_bwd, stack_case)
    np.testing.assert_allclose(got[0], stack_case["out"], **VAL_TOL)
    _assert_grads(got, stack_case["gx"], stack_case["cross"])


# ---------------------------------------------------------------------------
# Model level
# ---------------------------------------------------------------------------

SIZE, PATCH = 32, 8
N_PATCHES = (SIZE // PATCH) ** 2
VIT = dict(image_size=SIZE, patch_size=PATCH, dim=128, depth=2, n_heads=1,
           mlp_ratio=2.0, pos_embed="sincos", gelu="tanh")
DEC = dict(dim=128, depth=2, n_heads=1, mlp_ratio=2.0, gelu="tanh")


def _fill(shapes, seed):
    """A parameter tree of ``shapes`` from a numpy seed: kernels normal /
    sqrt(fan_in), LayerNorm scales 1 + 0.1 * normal, the rest 0.02 *
    normal."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        x = rng.normal(size=leaf.shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(leaf.shape[0])
        return 1.0 + 0.1 * x if name == "scale" else 0.02 * x

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _torch_masking(m) -> MaskingResult:
    return MaskingResult(*(torch.tensor(np.asarray(x, np.float32)) if i == 2
                           else torch.tensor(np.asarray(x, np.int64))
                           for i, x in enumerate(m)))


@pytest.fixture(scope="module")
def mae_case():
    """JAX's per-block cross-decoder MAEViT, its seeded weights, the images
    and masks, and its outputs and loss gradients (one jit)."""
    jmodel = jax_mae.MAEViT(jax_vit.ViTConfig(**VIT),
                            decoder=jax_mae.MAEDecoderConfig(**DEC),
                            decoder_style="cross", block_impl="off")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, SIZE, SIZE, 3)).astype(np.float32)
    masking = jax_masking.random_masking(jax.random.PRNGKey(2), B, N_PATCHES,
                                         0.75)
    shapes = jax.eval_shape(lambda r: jmodel.init(r, jnp.asarray(x), r),
                            jax.random.PRNGKey(0))
    params = _fill(shapes["params"], 1)

    def jax_side(p):
        def loss(p):
            o = jmodel.apply({"params": p}, jnp.asarray(x), None,
                             masking=masking)
            return mae_loss_jax(o), o

        (_, out), g = jax.value_and_grad(loss, has_aux=True)(p)
        full = jmodel.apply({"params": p}, jnp.asarray(x),
                            method=jmodel.encode_full)
        return out, g, full

    def mae_loss_jax(o):
        return jax_losses.mae_reconstruction_loss(o.pred_patches,
                                                  o.target_patches, o.mask)

    out, g, full = jax.jit(jax_side)(params)
    return dict(params=params, x=x, masking=masking, out=out, g=g,
                full=np.asarray(full))


def _torch_mae(params, block_impl):
    vcfg = ViTConfig(**VIT)
    model = MAEViT(vcfg, MAEDecoderConfig(**DEC), decoder_style="cross",
                   block_impl=block_impl)
    sd = from_jax._converted(params, model.state_dict())
    model.load_state_dict(sd, strict=True)
    return model


def test_mae_cross_decoder_fused_matches_jax(mae_case):
    """MAEViT with block_impl='on' on the CPU (the plain #6/#7 in the
    encoder and in the cross decoder) against JAX's per-block model:
    pooled, pred, and every gradient of the reconstruction loss."""
    model = _torch_mae(mae_case["params"], "on")
    out = model(torch.from_numpy(mae_case["x"]),
                masking=_torch_masking(mae_case["masking"]))
    want = mae_case["out"]
    for name in ("pooled", "pred_patches", "target_patches"):
        np.testing.assert_allclose(
            getattr(out, name).detach().numpy(),
            np.asarray(getattr(want, name)), **VAL_TOL, err_msg=name)
    mae_reconstruction_loss(out.pred_patches, out.target_patches,
                            out.mask).backward()
    want_g = from_jax._converted(
        jax.tree_util.tree_map(np.asarray, mae_case["g"]),
        model.state_dict())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   atol=1e-4, rtol=1e-3, err_msg=name)


def test_mae_encode_full_fused_matches_jax(mae_case):
    """encode_full (the serving tower) through the fused stack."""
    model = _torch_mae(mae_case["params"], "on")
    with torch.no_grad():
        got = model.encode_full(torch.from_numpy(mae_case["x"]))
    np.testing.assert_allclose(got.numpy(), mae_case["full"], **VAL_TOL)


# ---------------------------------------------------------------------------
# One CLIP training step
# ---------------------------------------------------------------------------

TEXT = dict(vocab_size=50, dim=32, n_layers=1, n_heads=2, hidden_dim=64,
            max_position_embeddings=32)
CLIP_VIT = dict(image_size=16, patch_size=8, dim=128, depth=2, n_heads=1)
CLIP_CFG = dict(model_name="vit_s16", image_embedding=128, projection_dim=8,
                size=16, batch_size=4, compute_dtype="float32", dropout=0.0,
                gelu_impl="tanh", lr=1e-3)
CLIP_MAE = dict(enabled=True, decoder_style="cross", mask_ratio=0.5,
                decoder_dim=128, decoder_depth=2, decoder_heads=1)
TOL = dict(atol=1e-4, rtol=1e-4)


def _clip_configs(fused):
    mae = dict(CLIP_MAE)
    return (jax_config.Config(**CLIP_CFG, fused_blocks="off",
                              mae=jax_config.MAEConfig(**mae)),
            torch_config.Config(**CLIP_CFG, fused_blocks=fused,
                                mae=torch_config.MAEConfig(**mae)))


@pytest.fixture(scope="module")
def clip_case():
    """JAX's per-block CLIP model and one jitted train step from seeded
    weights: the metrics and the updated parameters."""
    jcfg, _ = _clip_configs("on")
    jmodel = jax_clip.CLIPModel(
        jcfg, text_config=jax_distilbert.DistilBertConfig(**TEXT),
        vit_config=jax_vit.ViTConfig(**CLIP_VIT))
    b, n = CLIP_CFG["batch_size"], (16 // 8) ** 2
    rng = np.random.default_rng(8)
    batch = {"image": rng.integers(0, 256, (b, n, 192)).astype(np.uint8),
             "text_features": rng.normal(size=(b, 32)).astype(np.float32),
             "valid": np.array([True] * (b - 1) + [False])}
    init_batch = {"image": jnp.zeros((b, 16, 16, 3)),
                  "input_ids": jnp.zeros((b, 9), jnp.int32),
                  "attention_mask": jnp.ones((b, 9), jnp.int32)}
    shapes = jax.eval_shape(lambda r: jmodel.init(
        r, init_batch, mask_rng=jax.random.PRNGKey(1)), jax.random.PRNGKey(0))
    params = _fill(shapes["params"], 5)
    tx = jax_optim.make_optimizer(jcfg, params)
    rng0 = jax.random.PRNGKey(2)
    jstate = JaxTrainState.create(jax.tree_util.tree_map(jnp.array, params),
                                  tx, rng0)
    masking = jax_masking.random_masking(
        jax.random.fold_in(jax.random.fold_in(rng0, 0), 2), b, n,
        CLIP_MAE["mask_ratio"])
    jstate, metrics = jax_loop.make_train_step(jmodel, tx, jcfg)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(params=params, batch=batch, masking=masking,
                metrics={k: float(v) for k, v in metrics.items()},
                after=jax.tree_util.tree_map(np.asarray, jstate.params))


@pytest.mark.parametrize("fused", ["on", "fwd"])
def test_clip_train_step_fused_matches_jax(clip_case, fused, monkeypatch):
    """make_train_step on a CLIPModel with fused_blocks='on' / 'fwd' (the
    plain #6, and #7 or the per-block recompute, in the encoder and the
    cross decoder) against JAX's step: metrics and every parameter after
    the update, on the same weights and masks."""
    _, tcfg = _clip_configs(fused)
    model = CLIPModel(tcfg, DistilBertConfig(**TEXT), ViTConfig(**CLIP_VIT),
                      device="cpu")
    model.load_state_dict(from_jax.state_dict_from_flax(
        clip_case["params"], tcfg, model.text_config, model.vit_config),
        strict=True)
    stacks = []
    real = BK._stack_forward
    monkeypatch.setattr(BK, "_stack_forward",
                        lambda *a: stacks.append(a[5]) or real(*a))
    opt = make_optimizer(tcfg, model)
    step = make_train_step(model, opt, tcfg)
    got = step(TrainState.create(model, opt),
               {k: torch.from_numpy(v) for k, v in clip_case["batch"].items()},
               masking=_torch_masking(clip_case["masking"]))
    assert stacks == [False, True]   # the encoder, then the cross decoder
    for k, v in clip_case["metrics"].items():
        np.testing.assert_allclose(float(got[k]), v, **TOL, err_msg=k)
    want = from_jax.state_dict_from_flax(clip_case["after"], tcfg,
                                         model.text_config, model.vit_config)
    grads = {n: p.grad for n, p in model.named_parameters()}
    for name, p in model.state_dict().items():
        # Adam's first step divides by |g|: where a gradient is below 1e-6,
        # a rounding-level difference in it moves the update by up to lr
        # (atol 2 * lr there, as test_torch_train.py allows).
        g = grads.get(name)
        small = (g.abs() < 1e-6) if g is not None else torch.tensor(False)
        atol = torch.where(small, 2 * tcfg.lr, 1e-6)
        err = (p - want[name]).abs()
        assert not bool((err > atol + 1e-5 * want[name].abs()).any()), (
            name, float(err.max()))
