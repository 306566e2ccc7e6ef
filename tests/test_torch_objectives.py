"""The port's losses, optimizers and text-tower attention dropout against
the JAX package's, on the CPU in fp32, inputs made from numpy seeds.

* ``siglip_loss``, ``clip_hard_ce_loss`` and ``temperature_of``: values
  atol 1e-5 / rtol 1e-5, gradients atol 1e-5 / rtol 1e-3 (sums of small
  products in another order), on (8, 16) embeddings with a padded row.
* ``make_optimizer`` (AdamW, LAMB, Lion; the cosine schedule with warmup;
  clipping by the trainable global norm) against the JAX package's
  ``make_optimizer`` (optax, run eagerly) over 5 updates of one synthetic
  tree: an image, a text, a head, a 0-d logit and an all-zero leaf. The
  gradients are fed in, the same on both sides. Parameters atol 1e-6 /
  rtol 1e-5, except where a step's direction hangs on a rounding: Adam's
  and LAMB's where a gradient entry is below 1e-6 in magnitude (the first
  steps divide by |g|), Lion's where ``|b1 m + (1 - b1) g| < 1e-6`` (the
  sign flips); there the atol is 2 * lr * steps. The learning rates at
  counts 0, ``warmup_steps``, ``decay_steps`` and past it: rtol 1e-6.
* Attention dropout: ``attention_ref`` with JAX's keep mask
  (``jax.random.bernoulli``) fed in, against ``attention_xla`` drawing the
  same mask from the same key: output and q/k/v gradients atol 2e-5 /
  rtol 1e-4, as the attention tests use.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from mae_clip_tpu import config as jax_config
from mae_clip_tpu.ops import attention as jax_attn
from mae_clip_tpu.ops import losses as jax_losses
from mae_clip_tpu.train import optim as jax_optim
from mae_clip_torch import config as torch_config
from mae_clip_torch.models.distilbert import DistilBertConfig, TextEncoder
from mae_clip_torch.ops import attention as A
from mae_clip_torch.ops import losses as torch_losses
from mae_clip_torch.train import optim as torch_optim
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-3)


def _embeddings(seed=0, b=8, d=16):
    rng = np.random.default_rng(seed)
    img, txt = (rng.normal(size=(b, d)).astype(np.float32) for _ in range(2))
    valid = np.ones(b, bool)
    valid[5] = False
    return img, txt, valid


def _check(got, got_g, want, want_g):
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    for x, y in zip(got_g, want_g):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **GRAD_TOL)


@pytest.mark.parametrize("padded", [False, True])
def test_siglip_loss_matches_jax(padded):
    """Value and the gradients of both embeddings, the scale and the bias."""
    img, txt, valid = _embeddings(1)
    v = valid if padded else None
    scale, bias = np.float32(np.log(10.0)), np.float32(-10.0)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda a, b, s, c: jax_losses.siglip_loss(
            a, b, s, c, None if v is None else jnp.asarray(v)),
        argnums=(0, 1, 2, 3)))(*map(jnp.asarray, (img, txt, scale, bias)))
    args = [torch.tensor(x).requires_grad_() for x in (img, txt, scale,
                                                       bias)]
    got = torch_losses.siglip_loss(
        *args, None if v is None else torch.from_numpy(v))
    _check(got, torch.autograd.grad(got, args), want, want_g)


@pytest.mark.parametrize("padded", [False, True])
def test_clip_hard_ce_loss_matches_jax(padded):
    """Value and gradients, the temperature a learnable log-scale through
    ``temperature_of`` (its gradient included)."""
    img, txt, valid = _embeddings(2)
    v = valid if padded else None
    s = np.float32(np.log(1 / 0.07))
    want, want_g = jax.jit(jax.value_and_grad(
        lambda a, b, c: jax_losses.clip_hard_ce_loss(
            a, b, jax_losses.temperature_of(c),
            None if v is None else jnp.asarray(v)),
        argnums=(0, 1, 2)))(*map(jnp.asarray, (img, txt, s)))
    args = [torch.tensor(x).requires_grad_() for x in (img, txt, s)]
    got = torch_losses.clip_hard_ce_loss(
        args[0], args[1], torch_losses.temperature_of(args[2]),
        None if v is None else torch.from_numpy(v))
    _check(got, torch.autograd.grad(got, args), want, want_g)


@pytest.mark.parametrize("scale", [np.log(20.0), np.log(150.0)])
def test_temperature_of_matches_jax(scale):
    """Both sides of the clamp at exp(s) = 100: below it the gradient is
    the temperature's, above it 0."""
    s = np.float32(scale)
    want, want_g = jax.value_and_grad(jax_losses.temperature_of)(
        jnp.asarray(s))
    t = torch.tensor(s).requires_grad_()
    got = torch_losses.temperature_of(t)
    (got_g,) = torch.autograd.grad(got, t)
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(float(got_g), float(want_g), **GRAD_TOL)
    assert (float(got_g) == 0.0) == (scale > np.log(100.0))


# ---------------------------------------------------------------------------
# Optimizers, schedule, clipping
# ---------------------------------------------------------------------------

SHAPES = {"image_encoder/w": (4, 3), "text_encoder/w": (5,),
          "image_projection/w": (3, 2), "logit_scale": (),
          "text_projection/zero": (2, 3)}
STEPS = 5
WARMUP, DECAY = 2, 4


class Tree(nn.Module):
    """``SHAPES`` as torch parameters named as the JAX paths with dots."""

    def __init__(self, values):
        super().__init__()
        for path, x in values.items():
            *mods, leaf = path.split("/")
            owner = self
            for m in mods:
                if not hasattr(owner, m):
                    owner.add_module(m, nn.Module())
                owner = getattr(owner, m)
            owner.register_parameter(leaf, nn.Parameter(torch.tensor(x)))


def _jax_tree(flat):
    tree = {}
    for path, x in flat.items():
        *mods, leaf = path.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = jnp.asarray(x)
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _apply(tx, grads, state, params):
    updates, state = tx.update(grads, state, params)
    return optax.apply_updates(params, updates), state


@pytest.mark.parametrize("optimizer", ["adamw", "lamb", "lion"])
def test_optimizer_matches_optax(optimizer):
    """5 updates with warmup 2 / decay 4 (the lr at counts 0-4: 0, peak/2,
    peak, peak/2, 0), clipping on (the first three steps clip, the last two
    do not), weight decay 0.1 on all but the logit leaf; the zero leaf
    starts with a zero gradient, so both its norms are 0 (LAMB's ratio 1)."""
    kw = dict(optimizer=optimizer, lr=3e-2, weight_decay=0.1,
              text_trainable=True, lr_schedule="cosine",
              warmup_steps=WARMUP, decay_steps=DECAY, grad_clip_norm=2.5)
    jcfg, tcfg = jax_config.Config(**kw), torch_config.Config(**kw)
    rng = np.random.default_rng(3)
    values = {p: rng.normal(size=s).astype(np.float32)
              for p, s in SHAPES.items()}
    values["text_projection/zero"][:] = 0.0
    grads = []
    for i in range(STEPS):
        g = {p: (rng.normal(size=s) * (2.0 if i < 3 else 0.1)).astype(
            np.float32) for p, s in SHAPES.items()}
        if i == 0:
            g["text_projection/zero"][:] = 0.0
        grads.append(g)

    jparams = _jax_tree(values)
    tx = jax_optim.make_optimizer(jcfg, jparams)
    jstate = tx.init(jparams)
    update = jax.jit(lambda g, st, p: _apply(tx, g, st, p))
    tree = Tree(values)
    opt = torch_optim.make_optimizer(tcfg, tree)
    params = dict(tree.named_parameters())
    small, momentum = {}, {p: np.zeros(s, np.float32)
                           for p, s in SHAPES.items()}
    for i, g in enumerate(grads):
        jparams, jstate = update(_jax_tree(g), jstate, jparams)
        for path, x in g.items():
            params[path.replace("/", ".")].grad = torch.tensor(x)
        opt.step()
        for path in g:   # where a rounding can turn the step
            x = params[path.replace("/", ".")].grad.numpy()  # clipped
            if optimizer == "lion":
                hang = np.abs(0.9 * momentum[path] + 0.1 * x) < 1e-6
                momentum[path] = 0.99 * momentum[path] + 0.01 * x
            else:
                hang = np.abs(x) < 1e-6
            small[path] = small.get(path, False) | hang
        want = _flat(jparams)
        for path, w in want.items():
            atol = np.where(small[path], 2 * kw["lr"] * (i + 1), 1e-6)
            err = np.abs(params[path.replace("/", ".")].detach().numpy() - w)
            assert (err <= atol + 1e-5 * np.abs(w)).all(), (
                optimizer, i, path, float(err.max()))
    assert [g["count"] for g in opt.param_groups] == [STEPS] * 4
    for count in (0, WARMUP, DECAY, DECAY + 3):
        np.testing.assert_allclose(
            torch_optim.current_lr(tcfg, opt, count),
            jax_optim.current_lr(jcfg, jstate, count), rtol=1e-6,
            atol=1e-12)


def test_cosine_schedule_rejects_bad_lengths():
    """decay_steps 0 (as JAX) or not past the warmup (as optax)."""
    tree = Tree({"head/w": np.ones(2, np.float32)})
    for kw in (dict(decay_steps=0), dict(warmup_steps=4, decay_steps=4)):
        cfg = torch_config.Config(lr_schedule="cosine", **kw)
        with pytest.raises(ValueError, match="decay_steps"):
            torch_optim.make_optimizer(cfg, tree)
    with pytest.raises(ValueError, match="decay_steps"):
        jax_optim.make_optimizer(jax_config.Config(
            lr_schedule="cosine", decay_steps=0), {"head": {"w": jnp.ones(2)}})


# ---------------------------------------------------------------------------
# Text-tower attention dropout
# ---------------------------------------------------------------------------

def test_attention_dropout_matches_attention_xla():
    """The plain route with JAX's keep mask fed in: output and gradients."""
    rng = np.random.default_rng(4)
    b, h, s, d, rate = 2, 3, 9, 8, 0.25
    q, k, v, g = (rng.normal(size=(b, h, s, d)).astype(np.float32)
                  for _ in range(4))
    kv = np.ones((b, s), bool)
    kv[1, 6:] = False

    def fwd_bwd(x, y, z, dout):
        key = jax.random.PRNGKey(5)
        out, vjp = jax.vjp(lambda x, y, z: jax_attn.attention_xla(
            x, y, z, jnp.asarray(kv), 1 / d ** 0.5, rate, key), x, y, z)
        # The mask attention_xla draws from the key, for the port's side.
        keep = jax.random.bernoulli(key, 1.0 - rate, (b, h, s, s))
        return out, vjp(dout), keep

    want, want_g, keep = jax.jit(fwd_bwd)(*map(jnp.asarray, (q, k, v, g)))
    keep = np.array(keep)
    args = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = A.attention_ref(*args, torch.from_numpy(kv), 1 / d ** 0.5, rate,
                          keep=torch.from_numpy(keep))
    got_g = torch.autograd.grad(got, args, torch.from_numpy(g))
    tol = dict(atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    for x, y in zip(got_g, want_g):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **tol)
    assert 0 < (~keep).sum() < keep.size


def test_text_tower_routes_dropout_to_the_plain_attention(monkeypatch):
    """Train mode with attention_dropout > 0 takes attention_ref with
    torch's RNG (no kernel wrapper); eval mode, and train mode at rate 0,
    the flash wrapper."""
    calls = []
    real = A.flash_attention
    monkeypatch.setattr(A, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    config = DistilBertConfig(vocab_size=20, dim=16, n_layers=2, n_heads=2,
                              hidden_dim=32, max_position_embeddings=16,
                              dropout=0.0, attention_dropout=0.5)
    ids = torch.randint(0, 20, (2, 7), generator=torch.Generator()
                        .manual_seed(0))
    mask = torch.ones(2, 7, dtype=torch.long)
    mask[1, 4:] = 0
    tower = TextEncoder(config)
    torch.manual_seed(0)
    a = tower.train()(ids, mask)
    b = tower(ids, mask)
    assert not calls and not torch.equal(a, b)     # two draws
    with torch.no_grad():
        tower.eval()(ids, mask)
    assert len(calls) == config.n_layers
    TextEncoder(DistilBertConfig(**dict(
        config.__dict__, attention_dropout=0.0))).train()(ids, mask)
    assert len(calls) == 2 * config.n_layers
