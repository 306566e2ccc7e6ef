"""The reference recipe's training around the ResNet tower: the steps with
BatchNorm, the plateau scheduler, the index loader, the device store,
checkpoint retention and the ``Trainer`` (mae_clip_torch.train), against
the JAX package's; then the Trainer's own guarantees, JAX-free.

The model is a ResNet CLIP cut to one bottleneck of width 8 on 32x32
images, with a one-layer DistilBERT of width 16 (frozen), fp32, dropout 0
where values are compared; the JAX model's variables (params and
batch_stats, from ``jax.eval_shape`` of its ``init``: no compile) are
filled from a numpy seed and converted. JAX runs its XLA attention.

Tolerances: the one SGD(1) step's metrics within 1e-5 relative and its
parameters and statistics within 2e-5 (JAX sums BatchNorm statistics
sequentially on the CPU, the port in blocks; ``test_torch_resnet.py``);
accumulation as the JAX package's own test, parameters within 2e-5 and
statistics following ``s2 = 1.9 s1 - 0.9 s0`` within 1e-4 relative; the
Trainer's loss histories over two epochs of AdamW within 1e-4 relative
(Adam's first steps are sign-like, so rounding-level gradient differences
move the parameters by up to the lr).
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mae_clip_tpu import config as jax_config
from mae_clip_tpu.data import device_store as jax_store
from mae_clip_tpu.models import clip as jax_clip
from mae_clip_tpu.models import distilbert as jax_distilbert
from mae_clip_tpu.train import checkpoint as jax_ckpt
from mae_clip_tpu.train import loop as jax_loop
from mae_clip_tpu.train import metrics as jax_metrics
from mae_clip_tpu.train import optim as jax_optim
from mae_clip_tpu.train.state import TrainState as JaxTrainState
from mae_clip_torch import config as torch_config
from mae_clip_torch.data.device_store import (DeviceStore,
                                              build_device_store,
                                              make_index_loader)
from mae_clip_torch.interop.from_jax import state_dict_from_flax
from mae_clip_torch.models import CLIPModel, DistilBertConfig
from mae_clip_torch.train import (CheckpointManager, MetricWriter,
                                  ReduceLROnPlateau, StepCheckpointManager,
                                  Trainer, TrainState, current_lr,
                                  load_weights, make_eval_step,
                                  make_optimizer, make_train_step,
                                  set_lr_scale)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, SIZE, SEQ = 4, 32, 10
SHAPE = ((1,), (8,))
TEXT = dict(vocab_size=64, dim=16, n_layers=1, n_heads=2, hidden_dim=32,
            max_position_embeddings=32, dropout=0.0, attention_dropout=0.0)
CFG = dict(model_name="resnet50", image_embedding=32, projection_dim=8,
           size=SIZE, batch_size=B, compute_dtype="float32", dropout=0.0,
           text_trainable=False, pretrained=False, max_length=16)


def _configs(**kw):
    base = dict(CFG, **kw)
    return jax_config.Config(**base), torch_config.Config(**base)


def _batch(seed: int, padded: bool = True, halves: bool = False) -> dict:
    rng = np.random.default_rng(seed)
    n = B // 2 if halves else B
    img = rng.normal(size=(n, SIZE, SIZE, 3)).astype(np.float32)
    ids = rng.integers(2, 64, size=(n, SEQ)).astype(np.int32)
    mask = np.ones((n, SEQ), np.int32)
    mask[0, 6:] = 0
    if halves:   # each microbatch of 2 holds the whole batch's rows
        img, ids, mask = (np.concatenate([a, a]) for a in (img, ids, mask))
    valid = np.ones(B, bool)
    if padded:
        valid[-1] = False
    return {"image": img, "input_ids": ids, "attention_mask": mask,
            "valid": valid}


def _fill(rng):
    def fill(path, leaf):
        name = str(path[-1].key)
        v = rng.normal(size=leaf.shape).astype(np.float32)
        if name == "kernel":
            return v / np.sqrt(np.prod(leaf.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * v
        if name == "var":
            return 1.0 + 0.5 * np.abs(v)
        return 0.1 * v if name == "mean" else 0.02 * v
    return fill


@pytest.fixture(scope="module")
def setup():
    """The JAX model and its seeded variables (params and batch_stats)."""
    jcfg, tcfg = _configs()
    jmodel = jax_clip.CLIPModel(
        jcfg, text_config=jax_distilbert.DistilBertConfig(**TEXT),
        resnet_shape=SHAPE)
    batch = {k: jnp.asarray(v) for k, v in _batch(0).items()
             if k != "valid"}
    shapes = jax.eval_shape(lambda r: jmodel.init(r, batch),
                            jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map_with_path(
        _fill(np.random.default_rng(0)), shapes)
    return jcfg, tcfg, jmodel, variables


def _torch_model(tcfg, variables, text=TEXT) -> CLIPModel:
    model = CLIPModel(tcfg, DistilBertConfig(**text), device="cpu",
                      resnet_shape=SHAPE)
    model.load_state_dict(state_dict_from_flax(
        variables, tcfg, model.text_config, resnet_shape=SHAPE), strict=True)
    return model


def _torch_batch(batch) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _copy(tree):
    return jax.tree_util.tree_map(lambda a: jnp.array(np.asarray(a)), tree)


def _as_sd(tcfg, variables) -> dict:
    return state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables),
                                tcfg, DistilBertConfig(**TEXT),
                                resnet_shape=SHAPE)


def _jax_sgd_step(setup, batch, accum=1, true_global=True):
    """JAX's make_train_step with optax.sgd(1.0), called directly."""
    jcfg, _, jmodel, variables = setup
    tx = optax.sgd(1.0)
    state = JaxTrainState.create(_copy(variables["params"]), tx,
                                 jax.random.PRNGKey(2),
                                 _copy(variables["batch_stats"]))
    state, metrics = jax_loop.make_train_step(
        jmodel, tx, jcfg, accum_steps=accum,
        true_global_contrastive=true_global)(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
    return state, {k: float(v) for k, v in metrics.items()}


def _torch_sgd_step(setup, batch, accum=1, true_global=True, **cfg):
    _, tcfg, _, variables = setup
    tcfg = tcfg.replace(**cfg)
    model = _torch_model(tcfg, variables)
    opt = torch.optim.SGD([p for p in model.parameters() if p.requires_grad],
                          lr=1.0)
    state = TrainState.create(model, opt)
    metrics = make_train_step(model, opt, tcfg, accum_steps=accum,
                              true_global_contrastive=true_global)(
                                  state, _torch_batch(batch))
    return model, state, {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def one_step(setup):
    """One SGD(1) step of each side on the padded batch."""
    batch = _batch(1)
    return _jax_sgd_step(setup, batch), _torch_sgd_step(setup, batch)


def _assert_tree_close(got: dict, want: dict, atol: float, names=None):
    for k in (names if names is not None else want):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   want[k].numpy(), atol=atol, rtol=1e-5,
                                   err_msg=k)


def _stat_names(sd):
    return [k for k in sd if k.endswith(("running_mean", "running_var"))]


# ---------------------------------------------------------------------------
# Steps with the BatchNorm tower
# ---------------------------------------------------------------------------

def test_resnet_clip_step_matches_jax(setup, one_step):
    """One step with optax.sgd(1.0) / torch.optim.SGD(lr=1): the metrics,
    every parameter after it (trainable ones moved by their gradient), and
    the running statistics it updated (the padded row counted)."""
    tcfg = setup[1]
    (jstate, jm), (model, state, tm) = one_step
    assert set(tm) == set(jm) == {"loss", "clip_loss"}
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, err_msg=k)
    want = _as_sd(tcfg, {"params": jstate.params,
                         "batch_stats": jstate.batch_stats})
    got = model.state_dict()
    _assert_tree_close(got, want, 2e-5, [k for k in want
                                         if "num_batches" not in k])
    before = _as_sd(tcfg, setup[3])
    assert all(not torch.equal(got[k], before[k]) for k in _stat_names(got))
    assert state.step == 1


@pytest.mark.parametrize("true_global", [True, False],
                         ids=["gradcache", "legacy"])
def test_bn_accumulation_matches_jax(setup, true_global):
    """accum_steps=2 on two identical halves, JAX's step factory called
    directly (``Config.validate`` would refuse it): the parameters against
    JAX's, and the statistics updated once a microbatch, one after the
    other: ``s2 = 1.9 s1 - 0.9 s0`` with s1 the one-pass step's."""
    tcfg = setup[1]
    batch = _batch(2, padded=False, halves=True)
    jstate, jm = _jax_sgd_step(setup, batch, 2, true_global)
    model, _, tm = _torch_sgd_step(setup, batch, 2, true_global)
    one, _, _ = _torch_sgd_step(setup, batch)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, err_msg=k)
    want = _as_sd(tcfg, {"params": jstate.params,
                         "batch_stats": jstate.batch_stats})
    got = model.state_dict()
    _assert_tree_close(got, want, 2e-5, [k for k in want
                                         if "num_batches" not in k])
    s0, s1 = _as_sd(tcfg, setup[3]), one.state_dict()
    for k in _stat_names(got):
        np.testing.assert_allclose(got[k].numpy(),
                                   (1.9 * s1[k] - 0.9 * s0[k]).numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
        assert int(got[k.rsplit(".", 1)[0] + ".num_batches_tracked"]) == 2


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_gradcache_pass2_leaves_the_statistics(setup, remat):
    """JAX-free: GradCache's pass 2 re-runs each microbatch in train mode
    and must not update the running statistics again: after a step they
    equal pass 1's alone (each microbatch's train-mode forward, in order),
    each BatchNorm counted 2 updates, with ``remat`` (the text tower under
    ``torch.utils.checkpoint``; the ResNet is never recomputed) too."""
    _, tcfg, _, variables = setup
    batch = _batch(3, padded=False)
    model, _, _ = _torch_sgd_step(setup, batch, 2, True, remat=remat)
    ref = _torch_model(tcfg, variables)
    with torch.no_grad():
        for half in (slice(0, 2), slice(2, 4)):
            ref.encode_image(torch.from_numpy(batch["image"][half]),
                             train=True)
    got, want = model.state_dict(), ref.state_dict()
    for k in _stat_names(got):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert {int(v) for k, v in got.items()
            if k.endswith("num_batches_tracked")} == {2}


def test_ema_eval_reads_live_statistics(setup, one_step):
    """An eval on the EMA weights (here: the weights before the step)
    reads the live running statistics (the step's), as JAX's
    ``_eval_variables``; against JAX's eval step on the same state."""
    jcfg, tcfg, jmodel, variables = setup
    (jstate, _), (model, state, _) = one_step
    jcfg, tcfg = jcfg.replace(ema_decay=0.5), tcfg.replace(ema_decay=0.5)
    jstate = jstate.replace(ema_params=_copy(variables["params"]))
    before = _as_sd(tcfg, variables)
    state.ema = {n: before[n].clone() for n, p in model.named_parameters()
                 if p.requires_grad}
    batch = _batch(4)
    want = jax_loop.make_eval_step(jmodel, jcfg)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_eval_step(model, tcfg)(state, _torch_batch(batch))
    live = make_eval_step(model, tcfg.replace(ema_decay=0.0))(
        state, _torch_batch(batch))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    assert abs(float(got["loss"]) - float(live["loss"])) > 1e-4


# ---------------------------------------------------------------------------
# Scheduler, loader, store, checkpoints
# ---------------------------------------------------------------------------

def test_plateau_scale_and_lr_match_jax():
    """The same scale sequence as JAX's ``ReduceLROnPlateau`` on one metric
    sequence; after a reduction, ``current_lr`` equals JAX's and the next
    AdamW update (cosine schedule) equals optax's chain with the scale."""
    metrics = [1.0, 0.9, 0.95, 0.95, 0.95, 0.8, 0.85, 0.85, 0.85, 0.79,
               0.79, 0.79, 0.79]
    jsched, tsched = jax_optim.ReduceLROnPlateau(1, 0.5), \
        ReduceLROnPlateau(1, 0.5)
    scales = [(tsched.step(m), jsched.step(m)) for m in metrics]
    assert [a for a, _ in scales] == [b for _, b in scales]
    assert scales[-1][0] == 0.125
    assert tsched.state_dict() == jsched.state_dict()

    over = dict(lr_schedule="cosine", warmup_steps=1, decay_steps=10,
                lr=1e-2, weight_decay=1e-2)
    jcfg, tcfg = _configs(**over)
    w = np.random.default_rng(5).normal(size=(3, 4)).astype(np.float32)
    g = np.random.default_rng(6).normal(size=(3, 4)).astype(np.float32)
    params = {"image_projection": {"kernel": jnp.asarray(w)}}
    tx = jax_optim.make_optimizer(jcfg, params)
    jstate = tx.init(params)
    lin = torch.nn.Module()
    lin.image_projection = torch.nn.Linear(3, 4, bias=False)
    lin.image_projection.weight.data.copy_(torch.from_numpy(w.T.copy()))
    opt = make_optimizer(tcfg, lin)
    for count, scale in enumerate((1.0, 0.5, 0.25)):
        jstate = jax_optim.set_lr_scale(jstate, scale)
        set_lr_scale(opt, scale)
        np.testing.assert_allclose(current_lr(tcfg, opt, count),
                                   jax_optim.current_lr(jcfg, jstate, count),
                                   rtol=1e-6)
        upd, jstate = tx.update({"image_projection": {"kernel": jnp.asarray(
            g)}}, jstate, params)
        params = optax.apply_updates(params, upd)
        lin.image_projection.weight.grad = torch.from_numpy(g.T.copy())
        opt.step()
        assert opt.param_groups[0]["lr"] == pytest.approx(
            jax_optim.current_lr(jcfg, jstate, count), rel=1e-6)
        np.testing.assert_allclose(
            lin.image_projection.weight.detach().numpy().T,
            np.asarray(params["image_projection"]["kernel"]), atol=1e-6,
            rtol=1e-5)
    assert opt.state_dict()["param_groups"][0]["lr_scale"] == 0.25


@pytest.mark.parametrize("n,bs,shuffle,seed,drop_last", [
    (10, 4, False, 0, False), (10, 4, True, 3, False),
    (10, 4, True, 3, True), (7, 7, True, 1, False), (5, 8, True, 2, False)])
def test_index_loader_matches_jax(n, bs, shuffle, seed, drop_last):
    got = list(make_index_loader(n, bs, shuffle, seed, drop_last))
    want = list(jax_store.make_index_loader(n, bs, shuffle, seed, drop_last))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b) == {"indices", "valid"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype


def test_device_store_gather_matches_jax():
    """A deduped store (6 images, 12 rows, each image twice) gathers what
    JAX's gathers; ``build_device_store`` keeps token tables; a store on a
    host without the card must be asked for the CPU."""
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, size=(6, 4, 4, 3)).astype(np.uint8)
    ids = rng.integers(0, 64, size=(12, SEQ)).astype(np.int32)
    image_map = np.repeat(np.arange(6), 2).astype(np.int32)
    arrays = {"image": images, "input_ids": ids}
    store = DeviceStore(arrays, maps={"image": image_map}, device="cpu")
    jstore = jax_store.DeviceStore({k: jnp.asarray(v)
                                    for k, v in arrays.items()},
                                   maps={"image": image_map})
    assert store.n == jstore.n == 12
    idx = np.array([11, 0, 5, 5, 2], np.int32)
    got, want = store.gather(idx), jstore.gather(jnp.asarray(idx))
    assert set(got) == set(want) == {"image", "input_ids"}
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    class Captions:
        input_ids, attention_mask = ids, np.ones_like(ids)
    built = build_device_store(Captions(), images=np.repeat(images, 2, 0),
                               device="cpu")
    assert set(built.arrays) == {"image", "input_ids", "attention_mask"}
    with pytest.raises(NotImplementedError):
        build_device_store(Captions(), device="cpu")


def _tiny_state():
    lin = torch.nn.Linear(2, 2)
    return TrainState.create(lin, torch.optim.SGD(lin.parameters(), lr=0.1),
                             cfg=torch_config.Config())


def test_checkpoint_retention_matches_jax(tmp_path):
    """One loss sequence through both epoch managers (max_to_keep 2,
    keep_period 3) and both step managers: the same saved, kept, best and
    latest steps (JAX's are Orbax's)."""
    losses = [3.0, 2.0, 2.5, 1.0, 1.0, 4.0, 0.5, 0.7]
    jm = jax_ckpt.CheckpointManager(str(tmp_path / "j"), max_to_keep=2,
                                    keep_period=3)
    tm = CheckpointManager(str(tmp_path / "t"), max_to_keep=2,
                           keep_period=3)
    jstep = jax_ckpt.StepCheckpointManager(str(tmp_path / "js"))
    tstep = StepCheckpointManager(str(tmp_path / "ts"))
    jtree, state = {"w": jnp.zeros((2,))}, _tiny_state()
    for epoch, loss in enumerate(losses):
        jm.save(epoch, jtree, {"valid_loss": loss})
        assert tm.save(epoch, state, {"valid_loss": loss})
        jstep.save(10 * epoch, jtree, {"epoch": epoch})
        tstep.save(10 * epoch, state, {"epoch": epoch})
        jm.wait()
        jstep.wait()
        assert tm.all_steps() == list(jm._mngr.all_steps()), epoch
        assert tm.best_step() == jm.best_step()
        assert tm.latest_step() == jm.latest_step()
        assert tstep.all_steps() == list(jstep._mngr.all_steps())
    assert not tm.save(tm.latest_step(), state, {"valid_loss": 0.0})
    assert tstep.peek_meta() == {"epoch": len(losses) - 1}
    reopened = CheckpointManager(str(tmp_path / "t"), max_to_keep=2,
                                 keep_period=3)
    assert reopened.all_steps() == tm.all_steps()
    assert reopened.best_step() == tm.best_step()
    for m in (jm, jstep):
        m.close()


# ---------------------------------------------------------------------------
# The Trainer
# ---------------------------------------------------------------------------

def _loaders(seed: int, n_train: int = 3, n_valid: int = 2):
    """Per-epoch host batches (the last of each epoch has a padded row)."""
    def batches(epoch, n, offset):
        return [dict(_batch(1000 * seed + 100 * offset + 10 * epoch + i,
                            padded=(i == n - 1)))
                for i in range(n)]
    return (lambda epoch: iter(batches(epoch, n_train, 0)),
            lambda epoch: iter(batches(epoch, n_valid, 1)))


def test_trainer_fit_matches_jax(setup, tmp_path, monkeypatch):
    """Two epochs of recipe ``notebook`` (AdamW per tower, the plateau
    scheduler stepped each epoch, patience 0) from the same weights and
    batches: the loss histories, ``best_epoch`` and each epoch's lr against
    JAX's ``Trainer.fit``, and the same ``metrics.jsonl`` keys. (JAX's
    writer is kept from importing TensorFlow, which it would mirror the
    scalars into and which takes seconds to import.)"""
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    jcfg, tcfg, jmodel, variables = setup
    over = dict(recipe="notebook", epochs=2, patience=0, checkpoint_every=0,
                metric_fetch_every=2)
    jcfg, tcfg = jcfg.replace(**over), tcfg.replace(**over)
    train_fn, valid_fn = _loaders(0)
    jwriter = jax_metrics.MetricWriter(str(tmp_path / "j"))
    jtrainer = jax_loop.Trainer(jcfg, jmodel, _copy(variables["params"]),
                                batch_stats=_copy(variables["batch_stats"]),
                                writer=jwriter)
    want = jtrainer.fit(train_fn, valid_fn)
    jwriter.close()
    twriter = MetricWriter(str(tmp_path / "t"))
    trainer = Trainer(tcfg, _torch_model(tcfg, variables), writer=twriter)
    got = trainer.fit(train_fn, valid_fn)
    twriter.close()
    assert got["best_epoch"] == want["best_epoch"]
    for k in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    rows = {}
    for side in ("j", "t"):
        with open(tmp_path / side / "metrics.jsonl") as f:
            rows[side] = [json.loads(line) for line in f]
    assert [set(r) for r in rows["t"]] == [set(r) for r in rows["j"]]
    for a, b in zip(rows["t"], rows["j"]):
        assert a["lr"] == pytest.approx(b["lr"], rel=1e-6)
    assert trainer.state.step == int(jtrainer.state.step) == 6


def _port_trainer(setup, **cfg):
    _, tcfg, _, variables = setup
    tcfg = tcfg.replace(**cfg)
    return Trainer(tcfg, _torch_model(tcfg, variables))


def _zero_lr(**kw):
    return dict(lr=0.0, head_lr=0.0, image_encoder_lr=0.0,
                text_encoder_lr=0.0, checkpoint_every=0, **kw)


def test_early_stop_halts_on_plateau(setup):
    """As the JAX package's test: a valid loss that never improves keeps
    epoch 0 the best, so ``early_stop_patience=2`` stops after epoch 2 of
    10, and ``eval_fn`` runs on that epoch too."""
    trainer = _port_trainer(setup, **_zero_lr(epochs=10,
                                              early_stop_patience=2))
    # lr 0 alone does not fix a BatchNorm tower's valid loss (its running
    # statistics move): the eval step gives the same loss every epoch.
    trainer.eval_step = lambda state, batch: {"loss": torch.tensor(1.0)}
    fired = []
    train_fn, valid_fn = _loaders(1, n_train=1, n_valid=1)
    history = trainer.fit(train_fn, valid_fn,
                          eval_fn=lambda tr, ep: fired.append(ep) or {})
    assert history["stopped_early"] is True
    assert len(history["train_loss"]) == 3
    assert history["best_epoch"] == 0
    assert history["best_valid_loss"] == history["valid_loss"][0]
    assert fired == [0, 1, 2]


def test_eval_every_cadence(setup):
    """``eval_every=3`` over 6 epochs calls ``eval_fn`` at 2 and 5 only."""
    trainer = _port_trainer(setup, **_zero_lr(epochs=6, eval_every=3))
    fired = []
    train_fn, valid_fn = _loaders(1, n_train=1, n_valid=1)
    history = trainer.fit(
        train_fn, valid_fn,
        eval_fn=lambda tr, ep: fired.append(ep) or {"eval/recall@1": 0.5})
    assert fired == [2, 5]
    assert history["eval/recall@1"] == [0.5, 0.5]
    assert "stopped_early" not in history


def _store_run(setup, **cfg):
    """Two epochs over a deduped CPU store (10 rows, 5 images, batches of
    4: the last one ragged) with dropout on: history, parameters."""
    rng = np.random.default_rng(8)
    images = rng.normal(size=(5, SIZE, SIZE, 3)).astype(np.float32)
    ids = rng.integers(2, 64, size=(10, SEQ)).astype(np.int32)
    store = DeviceStore({"image": images, "input_ids": ids,
                         "attention_mask": np.ones_like(ids)},
                        maps={"image": np.repeat(np.arange(5), 2)},
                        device="cpu")
    _, tcfg, _, variables = setup
    tcfg = tcfg.replace(epochs=2, dropout=0.1, frozen_text_eval_mode=False,
                        checkpoint_every=0, **cfg)
    torch.manual_seed(0)
    model = _torch_model(tcfg, variables, dict(TEXT, dropout=0.1,
                                                attention_dropout=0.1))
    trainer = Trainer(tcfg, model, train_store=store, valid_store=store)
    history = trainer.fit(
        lambda e: make_index_loader(10, B, True, seed=e),
        lambda e: make_index_loader(10, B))
    return history, {k: v.clone() for k, v in model.state_dict().items()}


def test_steps_per_call_and_fetch_cadence_change_nothing(setup):
    """``metric_fetch_every`` and ``steps_per_call=3`` read the losses at
    another cadence; the histories and the final state are bit for bit
    those of reading every step."""
    base = _store_run(setup, metric_fetch_every=1, steps_per_call=1)
    for cfg in (dict(metric_fetch_every=4, steps_per_call=1),
                dict(steps_per_call=3)):
        other = _store_run(setup, **cfg)
        assert other[0] == base[0], cfg
        for k, v in base[1].items():
            assert torch.equal(other[1][k], v), (cfg, k)


def test_mid_epoch_resume_is_bit_identical(setup, tmp_path):
    """A ResNet tower with dropout in the heads and the frozen text tower
    in train mode: a run stopped after 4 of 6 batches resumes from its step
    checkpoint in a new Trainer and ends with the uninterrupted run's
    parameters, BatchNorm buffers and losses, bit for bit."""
    _, tcfg, _, variables = setup
    tcfg = tcfg.replace(epochs=1, dropout=0.1, frozen_text_eval_mode=False,
                        checkpoint_every_steps=2)
    text = dict(TEXT, dropout=0.1, attention_dropout=0.1)
    train_fn, valid_fn = _loaders(2, n_train=6, n_valid=1)

    def make(directory):
        torch.manual_seed(0)
        return Trainer(tcfg, _torch_model(tcfg, variables, text),
                       step_checkpoint_manager=StepCheckpointManager(
                           str(directory)))

    straight = make(tmp_path / "a")
    want = straight.fit(train_fn, valid_fn)
    broken = make(tmp_path / "b")
    it = train_fn(0)
    broken.train_epoch(iter([next(it) for _ in range(4)]))
    torch.manual_seed(123)                   # a new process's RNG
    resumed = make(tmp_path / "b")
    epoch, done = resumed.restore_mid_epoch()
    assert (epoch, done) == (0, 4) and resumed.state.step == 4
    got = resumed.fit(train_fn, valid_fn, start_epoch=epoch,
                      skip_batches=done)
    assert got["valid_loss"] == want["valid_loss"]
    a, b = resumed.model.state_dict(), straight.model.state_dict()
    assert any(k.endswith("running_var") for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert resumed.state.step == straight.state.step == 6


def test_ema_fit_checkpoint_round_trip(setup, tmp_path):
    """EMA through ``fit``: the best-epoch checkpoint holds it, a new
    Trainer restores it bit for bit, and ``load_weights`` serves the EMA
    weights for an ``ema_eval`` config (the live ones without)."""
    _, tcfg, _, variables = setup
    tcfg = tcfg.replace(epochs=1, ema_decay=0.9)
    train_fn, valid_fn = _loaders(3, n_train=2, n_valid=1)
    trainer = Trainer(tcfg, _torch_model(tcfg, variables),
                      checkpoint_manager=CheckpointManager(
                          str(tmp_path / "c")))
    trainer.fit(train_fn, valid_fn)
    assert trainer.checkpoint_manager.all_steps() == [0]
    other = Trainer(tcfg, _torch_model(tcfg, variables),
                    checkpoint_manager=CheckpointManager(str(tmp_path / "c")))
    assert other.restore() == 0
    assert other.state.step == trainer.state.step == 2
    for k, v in trainer.state.ema.items():
        assert torch.equal(other.state.ema[k], v), k
        assert not torch.equal(v, trainer.model.state_dict()[k])
    served = load_weights(str(tmp_path / "c"), tcfg)
    raw = load_weights(str(tmp_path / "c"), tcfg.replace(ema_eval=False))
    live = trainer.model.state_dict()
    for k, v in live.items():
        assert torch.equal(raw[k], v), k
        want = trainer.state.ema.get(k, v)
        assert torch.equal(served[k], want), k
    with pytest.raises(NotImplementedError):
        load_weights("model.pth", tcfg)


def test_mae_objective_fits_and_refuses_accumulation():
    """``objective='mae'``: a standalone MAEViT trains and validates on
    image-only batches (the pretraining steps), and accumulation, a
    contrastive recipe, is refused as in JAX."""
    from mae_clip_torch.models import ViTConfig, mae_vit_for

    mae = torch_config.MAEConfig(enabled=True, decoder_style="full",
                                 mask_ratio=0.75, decoder_dim=16,
                                 decoder_depth=1, decoder_heads=2)
    cfg = torch_config.Config(batch_size=B, size=16, compute_dtype="float32",
                              epochs=2, mae=mae, checkpoint_every=0)
    model = mae_vit_for(cfg, ViTConfig(image_size=16, patch_size=8, dim=16,
                                       depth=1, n_heads=2), device="cpu")
    rng = np.random.default_rng(9)
    batches = [{"image": rng.integers(0, 256, (B, 16, 16, 3)).astype(
        np.uint8), "valid": np.array([True] * (B - 1) + [False])}
        for _ in range(2)]
    history = Trainer(cfg, model, objective="mae").fit(
        lambda: iter(batches), lambda: iter(batches[:1]))
    assert np.isfinite(history["train_loss"] + history["valid_loss"]).all()
    with pytest.raises(ValueError, match="accum"):
        Trainer(cfg.replace(accum_steps=2), model, objective="mae")


def test_a_mesh_of_more_devices_raises(setup):
    _, tcfg, _, variables = setup
    with pytest.raises(NotImplementedError, match="mesh"):
        Trainer(tcfg.replace(mesh=torch_config.MeshConfig(data=2)),
                _torch_model(tcfg, variables))
