"""Typed configuration of the PyTorch port (its own copy of
``mae_clip_tpu/config.py``: the same dataclasses, fields, defaults and presets,
so one config file or ``to_dict()`` describes a run of either package; a test
holds the two ``to_dict()`` outputs equal for every preset).

The field comments below were written for the JAX package; they describe
what each knob means, not how the port runs, and they carry no
measurement (the port's are in ``PERF.md``). Of the TPU-specific fields
the port reads ``compute_dtype``, ``param_dtype``, ``gelu_impl``,
``image_heads``, ``text_heads``, ``fused_blocks``, ``remat``, and in the
``Trainer`` ``metric_fetch_every`` and ``steps_per_call`` (when the losses
are read), and ``mesh`` only to refuse more than one device. It reads
neither ``use_pallas`` nor ``mae.decoder_attn_impl`` (they choose between
routes that compute the same function) nor ``device_data*`` (the caller
builds a ``DeviceStore``).

Field names and default values intentionally mirror the reference's flat config
module (reference: config.py:1-37) so that users of the reference find the same
knobs with the same semantics; TPU-specific fields are additive.

Two training recipes from the reference are expressible:
  * the ``.py`` recipe (reference: main.py:101-107): single AdamW group,
    lr=1e-3, wd=1e-3, frozen text tower, scheduler that never fires;
  * the notebook recipe ("OpenAI CLIP Simple Implementation.ipynb" cells 13,
    47): per-tower LRs (head 1e-3 / image 1e-4 / text 1e-5), wd on heads only,
    epoch-level ReduceLROnPlateau.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MAEConfig:
    """Masked-autoencoder objective (capability the reference names but never
    shipped; see reference modules.py:20-26 for the commented-out ViT tower)."""

    enabled: bool = False
    mask_ratio: float = 0.75
    decoder_dim: int = 256
    decoder_depth: int = 4
    # TPU-first choice: head_dim = decoder_dim/heads = 128 exactly fills the
    # MXU contraction lanes, at the same FLOPs as more, narrower heads
    # (attention FLOPs don't depend on head count); MAE reconstruction is
    # insensitive to decoder head count (the paper ablates depth/width
    # only, arXiv:2111.06377).
    decoder_heads: int = 2
    # Decoder MLP activation: "tanh" (default; cheaper than erf, no parity
    # constraint on the never-shipped decoder) or "erf" (torch GELU).
    decoder_gelu: str = "tanh"
    norm_pix_loss: bool = True
    # On-device augmentation source geometry (ops/augment.py): the MAE
    # input path decodes each image ONCE at this fixed square size
    # (cacheable / HBM-stageable) and samples RandomResizedCrop+flip to
    # ``size`` inside the jitted train step. >size keeps real
    # down-sampling diversity in the crops.
    aug_source_size: int = 256
    # Joint objective weight: L = L_infonce + lambda * L_mae.
    loss_weight: float = 1.0
    # Decoder attention impl override (None = inherit the model-wide one):
    # the decoder runs the full 197-token sequence at few heads, a distinct
    # perf regime from the towers. "xla" | "pallas" | "pallas_qkv" | "auto".
    decoder_attn_impl: Optional[str] = None
    # "full": MAE-paper decoder (self-attention over the scatter-restored
    # full sequence, arXiv:2111.06377). "cross": CrossMAE — decode only the
    # masked positions with cross-attention to the encoded visible tokens
    # (arXiv:2401.14391; comparable reconstruction quality, ~25% fewer
    # decoder tokens, no scatter, linear instead of quadratic attention).
    decoder_style: str = "full"
    # True (FLIP recipe, arXiv:2212.00794): the contrastive features come
    # from the shared 25%-visible-patch encoder pass — one image-tower pass
    # feeds both objectives (one tower pass instead of two).
    # False: classic joint objective — a SEPARATE full-sequence pass over
    # the same tower params feeds the contrastive loss (what inference
    # sees), the masked pass feeds only MAE reconstruction.
    clip_from_masked: bool = True


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout. ``data`` shards the batch (DP), ``model`` shards
    tower weights (TP). Sizes of -1 mean "all remaining devices"."""

    data: int = -1
    model: int = 1
    axis_names: Tuple[str, str] = ("data", "model")
    # ZeRO-1-style optimizer-state sharding: AdamW moments are elementwise
    # in the update, so their leading dim shards over the 'data' axis with
    # no math change — optimizer HBM drops ~1/D per chip (GSPMD inserts
    # the gather where the update meets replicated params). Leaves whose
    # dim0 doesn't divide the axis stay replicated.
    shard_opt_state: bool = False


@dataclasses.dataclass(frozen=True)
class Config:
    # --- reference-parity fields (reference: config.py:3-36) ---
    debug: bool = False
    image_path: str = "./dataset/images"
    captions_path: str = "./dataset"
    batch_size: int = 8              # per-step GLOBAL batch
    num_workers: int = 0
    lr: float = 1e-3
    weight_decay: float = 1e-3
    patience: int = 2
    factor: float = 0.5
    epochs: int = 10
    # Stop when valid loss hasn't improved for this many consecutive
    # epochs (0 = never; the reference trains a fixed epoch budget,
    # main.py:103-126). ``epochs`` stays the hard cap. Used by the
    # convergence protocol in results/synth32k (run-to-plateau claims
    # instead of fixed-budget artifacts).
    early_stop_patience: int = 0
    # Cadence for the optional eval_fn (retrieval recall@K etc.): run it
    # every N epochs, plus always on the final epoch (incl. the epoch an
    # early stop triggers on). 1 = every epoch. Valid loss (the
    # early-stop signal) is computed every epoch regardless. At synth32k
    # scale the retrieval eval dominates the epoch tail, so convergence
    # runs set this to 3-5.
    eval_every: int = 1

    model_name: str = "resnet50"     # image tower: resnet50 | vit_s16 | vit_b16
    image_embedding: int = 2048
    text_encoder_model: str = "distilbert-base-uncased"
    text_embedding: int = 768
    text_tokenizer: str = "distilbert-base-uncased"
    max_length: int = 200

    pretrained: bool = False         # no-egress default; True requires local weights
    trainable: bool = True           # image tower trainable
    text_trainable: bool = False     # reference freezes text tower (modules.py:35)
    # LiT-style: run a FROZEN text tower in eval mode during training (no
    # dropout noise in the contrastive targets, and the step is faster).
    # The reference keeps train-mode dropout active inside its frozen tower
    # (main.py:113 model.train() with requires_grad=False, modules.py:42-43);
    # reference_py_config pins that faithful behavior with False.
    frozen_text_eval_mode: bool = True
    temperature: float = 1.0

    size: int = 224

    num_projection_layers: int = 1
    projection_dim: int = 256
    dropout: float = 0.1

    logdir: str = "./output/mae_clip_tpu"
    checkpoints: str = "./output/mae_clip_tpu/checkpoints"

    # --- recipe selection ---
    # "py": single AdamW group + scheduler that never steps (main.py:60-61,107)
    # "notebook": per-tower LRs + epoch ReduceLROnPlateau
    recipe: str = "py"
    head_lr: float = 1e-3
    image_encoder_lr: float = 1e-4
    text_encoder_lr: float = 1e-5
    scheduler_step: str = "epoch"    # "epoch" | "batch" | "none"
    # Step-wise base-LR schedule, composed with the plateau scale above.
    # "constant" is the reference's effective behavior; "cosine" = linear
    # warmup over warmup_steps then cosine decay to 0 at decay_steps TOTAL
    # steps (MAE-paper pretraining schedule, arXiv:2111.06377 §A.1). The
    # schedule runs inside the jitted update (optimizer count) — no host
    # sync. decay_steps=0 + cosine => the CLI computes epochs x
    # steps-per-epoch; library users must set it explicitly.
    lr_schedule: str = "constant"    # "constant" | "cosine"
    warmup_steps: int = 0
    decay_steps: int = 0
    # Global-norm gradient clipping applied to the raw grads BEFORE the
    # per-group AdamW transforms (torch semantics: clip_grad_norm_ then
    # optimizer.step()). 0 disables (the reference never clips). The norm
    # is taken over TRAINABLE leaves only — frozen towers still receive
    # real (discarded) grads from the joint backward, and torch would
    # never count requires_grad=False params in the clip norm.
    grad_clip_norm: float = 0.0
    # Exponential moving average of the trainable params, updated inside
    # the jitted step (new_ema = d*ema + (1-d)*p; frozen leaves alias).
    # 0 disables (the reference has no EMA); typical 0.999-0.9999. With
    # ema_eval, validation/eval and checkpoint-served inference use the
    # EMA weights (the standard protocol, e.g. MoCo/BYOL evals).
    ema_decay: float = 0.0
    ema_eval: bool = True

    # --- TPU-native fields ---
    # Tower GELU override: None keeps each tower's parity-exact erf GELU
    # (torch nn.GELU / HF default — required for .pth weight interop).
    # "tanh" switches BOTH towers to the cheaper approximation; for
    # from-scratch recipes only.
    gelu_impl: Optional[str] = None  # None | "erf" | "tanh"
    # Attention-head overrides: None keeps each tower's canonical geometry
    # (ViT-S/16: 6 heads of 64; DistilBERT: 12 heads of 64 — required for
    # timm/HF weight interop). head_dim 128 exactly fills the MXU's
    # 128-lane contraction; same FLOPs either way. For from-scratch
    # recipes only (flagship: 3 and 6).
    image_heads: Optional[int] = None
    text_heads: Optional[int] = None
    seed: int = 42
    compute_dtype: str = "bfloat16"  # matmul/activation dtype on TPU
    param_dtype: str = "float32"
    use_pallas: str = "auto"         # "auto" | "always" | "never"
    # Fused Pallas transformer-block-stack kernels (ops/block_kernel.py)
    # for the ViT encoder and CrossMAE decoder: whole block stacks run
    # with weights resident in VMEM while the batch streams through.
    # "auto" engages on TPU when the geometry qualifies (head_dim % 128
    # == 0, dropout-free blocks — the flagship recipe); canonical
    # timm/HF geometries and CPU keep the per-block XLA path. "off"
    # forces XLA; "on" forces the kernel (tests); "fwd" = Pallas forward
    # + XLA-autodiff remat backward (the round-3 second fusion strategy,
    # see BASELINE.md).
    # Default "off": the JAX package keeps the per-block path until the
    # kernel wins on its hardware (BASELINE.md); the port keeps it until a
    # measurement on the card decides.
    fused_blocks: str = "off"        # "auto" | "on" | "off"
    # LiT-style frozen-text feature cache: precompute the (frozen,
    # eval-mode) text tower's features once per dataset and skip the tower
    # in every train step. None = auto: enabled
    # exactly when text_trainable=False and frozen_text_eval_mode=True
    # (the only configuration where it is mathematically a no-op).
    cache_text_features: Optional[bool] = None
    # Host-RAM cache of decoded (resized/patchified) images, deduped by
    # filename: epoch 1 pays the JPEG decode, epochs 2+ are array gathers.
    # Opt-in because it holds the whole decoded dataset in host memory
    # (~150 KB/image at 224px uint8). Augmented loads (MAE pretraining
    # crops) bypass it by design.
    cache_images: bool = False
    # Stage the WHOLE decoded dataset in device HBM and feed train/eval
    # steps by on-device index gather (data.device_store): per-step H2D
    # drops from the full batch to a (B,) index vector. For datasets that
    # fit HBM (~150 KB/image at 224px uint8 patches). Implies the decode
    # cost is paid once, like cache_images, but in device memory.
    device_data: bool = False
    # With device_data: also stage the VALIDATION set (True, default).
    # False keeps validation on the standard file-loader path — frees the
    # valid store's HBM for training (the train-rate path is what device
    # staging exists for; at 100k-row scale the two stores plus no-remat
    # activations can exceed one device's memory).
    device_data_eval: bool = True
    # Row-shard the device store over the mesh 'data' axis instead of
    # replicating it: each DP shard holds 1/D of the dataset, so stageable
    # capacity scales with mesh size. Batches come from blocked per-shard
    # index loaders (data.device_store.make_sharded_index_loader) and the
    # hot-path gather is a collective-free shard_map local take. Ignored
    # without a mesh. Single-controller only (multi-HOST runs should use
    # per-host file sharding, data/shards.py).
    device_data_sharded: bool = False
    # Recompute each tower block in the backward instead of keeping its
    # activations (jax.checkpoint; in the port torch.utils.checkpoint per
    # block of the per-block ViT/MAE encoder and DistilBERT, not the MAE
    # decoder's or a fused stack's).
    remat: bool = False
    # Trainer metric cadence: fetch train-step losses device->host every N
    # steps instead of every step. On a remote TPU a value fetch is the
    # only true barrier and costs a full round-trip; fetching per step
    # (the reference's loss.item(), main.py:64) serializes the pipeline.
    # Per-step fetching still happens when something needs the value each
    # batch (scheduler_step="batch", tqdm postfix). 1 = reference behavior.
    metric_fetch_every: int = 16
    # Device-resident superstep: with device_data, run K train/eval steps
    # per dispatch (lax.scan over a (K, B) index matrix, batches gathered
    # on device inside the scan). On a remote/tunneled TPU each dispatch
    # costs a host round trip; scanning amortizes it to 1/K. 0 = auto (use
    # metric_fetch_every when the store path is active), 1 = off. Forced
    # to 1 when something needs per-step host values (scheduler_step=
    # "batch", tqdm progress).
    steps_per_call: int = 0
    # Checkpoint cadence: best-val epochs are ALWAYS saved (the
    # reference's only policy, main.py:118-122), plus every N epochs and
    # the final epoch. 0 disables saving entirely (throwaway/bench runs).
    # A full-TrainState save streams the whole state device->host; async
    # Orbax overlaps it with the NEXT epoch's compute.
    checkpoint_every: int = 1
    # Step-granular (mid-epoch) checkpointing for preemption recovery:
    # every N train BATCHES the full TrainState is saved to a rolling
    # <checkpoints>/steps/ directory (train.checkpoint.
    # StepCheckpointManager) with (epoch, batches_done) meta, and
    # `cli train --resume` / Trainer.restore_mid_epoch fast-forward the
    # deterministic per-epoch loader to resume bit-identically. 0 = off
    # (epoch-level best-val checkpointing only, the reference's cadence).
    checkpoint_every_steps: int = 0
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    global_contrastive: bool = True  # all-gather embeddings for global-batch loss
    loss_chunk_size: int = 0         # 0 = unchunked; >0 = blockwise global loss
    # Gradient accumulation: split each global batch into this many
    # microbatches scanned sequentially with ONE optimizer update
    # (train.loop.make_train_step). >1 uses the GradCache two-pass recipe
    # (Gao et al., arXiv:2101.06983): the contrastive loss — and the
    # parameter grads — are EXACTLY those of the giant-batch step (the
    # contrastive batch stays batch_size x mesh-global, NOT the
    # microbatch), at ~1.5x step FLOPs but O(microbatch) activation
    # memory. This is what makes the 32k recipe (BASELINE.json config 5)
    # a true 32k x 32k objective on few chips. Requires batch_size %
    # accum_steps == 0. BatchNorm towers (resnet50) are supported with
    # torch accumulation semantics: each microbatch normalizes by its
    # own statistics, running stats update sequentially (giant-batch
    # equality holds exactly only for stat-free towers like ViT).
    accum_steps: int = 1
    # Inner optimizer for every trainable param group: "adamw" (the
    # reference's, main.py:101-103), "lamb" (layerwise trust-ratio AdamW,
    # arXiv:1904.00962 — the standard large-batch choice for the 32k
    # recipe), or "lion" (sign-momentum, arXiv:2302.06675 — one moment
    # instead of two, halving optimizer HBM; use ~10x smaller LR).
    optimizer: str = "adamw"
    # Contrastive objective: "softmax" = the reference's soft-target
    # symmetric InfoNCE (CLIP.py:34-43, uses `temperature`). "clip" = the
    # standard CLIP-paper objective (arXiv:2103.00020 fig. 3): L2-normalized
    # embeddings, hard identity targets, symmetric CE — pair it with
    # learnable_temperature=True + temperature=0.07 for the paper recipe
    # (its chunked global form needs only one streaming pass, so it honors
    # loss_chunk_size too). "siglip" = pairwise sigmoid loss
    # (arXiv:2303.15343) with learnable log-scale + bias params owned by
    # the model; its global version rides an ICI ring (ppermute) instead of
    # an all-gather, so memory stays O(local_B^2) at any global batch.
    contrastive_loss: str = "softmax"
    # Learnable temperature for the softmax objective (the CLIP paper's
    # exp(logit_scale) parameterization, scale clamped at 100): the model
    # owns a log-space `logit_scale` param initialized to log(1/temperature)
    # so `temperature` becomes the INITIAL value instead of a constant.
    # The reference's fixed T=1.0 stays the default (False). SigLIP's
    # temperature is always learnable (its own scale/bias params).
    # NOTE: the CLIP paper pairs T=0.07 with DETACHED hard targets and a
    # 32k batch; this framework's softmax objective keeps the reference's
    # no-detach soft targets (CLIP.py:35-39), which are unstable at sharp
    # temperatures + small batches + lr >= ~5e-4 — prefer T init 1.0, or
    # drop the LR, when training small from-scratch models.
    learnable_temperature: bool = False
    mae: MAEConfig = dataclasses.field(default_factory=MAEConfig)

    # vocab file for the builtin WordPiece tokenizer (HF-format vocab.txt)
    vocab_file: Optional[str] = None

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def validate(self) -> None:
        if self.recipe not in ("py", "notebook"):
            raise ValueError(f"unknown recipe {self.recipe!r}")
        if self.scheduler_step not in ("epoch", "batch", "none"):
            raise ValueError(f"unknown scheduler_step {self.scheduler_step!r}")
        if self.gelu_impl not in (None, "erf", "tanh"):
            raise ValueError(f"unknown gelu_impl {self.gelu_impl!r}")
        if self.use_pallas not in ("auto", "always", "never"):
            raise ValueError(f"unknown use_pallas {self.use_pallas!r}")
        if self.fused_blocks not in ("auto", "on", "off", "fwd"):
            raise ValueError(f"unknown fused_blocks {self.fused_blocks!r}")
        if self.model_name not in ("resnet50", "vit_s16", "vit_b16"):
            raise ValueError(f"unknown model_name {self.model_name!r}")
        if self.steps_per_call < 0:
            raise ValueError("steps_per_call must be >= 0")
        if self.accum_steps < 1:
            raise ValueError("accum_steps must be >= 1 (1 disables)")
        if self.accum_steps > 1:
            if self.batch_size % self.accum_steps:
                raise ValueError(
                    f"batch_size ({self.batch_size}) must be divisible by "
                    f"accum_steps ({self.accum_steps}) — microbatches are "
                    "equal static-shape slices")
            if self.model_name == "resnet50":
                raise ValueError(
                    "accum_steps > 1 needs a BatchNorm-free tower: "
                    "cross-microbatch BN stat merging is unimplemented — "
                    "use a ViT image tower")
        if self.grad_clip_norm < 0:
            raise ValueError("grad_clip_norm must be >= 0 (0 disables)")
        if not 0.0 <= self.ema_decay < 1.0:
            raise ValueError("ema_decay must be in [0, 1) (0 disables)")
        if self.checkpoint_every < 0:
            raise ValueError("checkpoint_every must be >= 0 (0 disables)")
        if self.early_stop_patience < 0:
            raise ValueError(
                "early_stop_patience must be >= 0 (0 disables)")
        if self.eval_every < 1:
            raise ValueError("eval_every must be >= 1")
        if self.checkpoint_every_steps < 0:
            raise ValueError(
                "checkpoint_every_steps must be >= 0 (0 disables)")
        if not 0.0 <= self.mae.mask_ratio < 1.0:
            raise ValueError("mask_ratio must be in [0, 1)")
        if self.mae.decoder_style not in ("full", "cross"):
            raise ValueError(
                f"unknown decoder_style {self.mae.decoder_style!r}")
        if self.lr_schedule not in ("constant", "cosine"):
            raise ValueError(f"unknown lr_schedule {self.lr_schedule!r}")
        if self.optimizer not in ("adamw", "lamb", "lion"):
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if self.contrastive_loss not in ("softmax", "clip", "siglip"):
            raise ValueError(
                f"unknown contrastive_loss {self.contrastive_loss!r}")
        if self.learnable_temperature and self.contrastive_loss == "siglip":
            raise ValueError(
                "learnable_temperature applies to the softmax objective; "
                "siglip's temperature is always learnable")
        if self.temperature <= 0:
            raise ValueError("temperature must be > 0")
        if self.cache_text_features and (
                self.text_trainable or not self.frozen_text_eval_mode):
            raise ValueError(
                "cache_text_features=True requires a frozen text tower in "
                "eval mode (text_trainable=False, frozen_text_eval_mode="
                "True) — otherwise cached features are wrong")

    @property
    def text_cache_enabled(self) -> bool:
        """Resolved cache_text_features (None = auto; see field docs)."""
        if self.cache_text_features is not None:
            return self.cache_text_features
        return (not self.text_trainable) and self.frozen_text_eval_mode

    @property
    def image_feature_dim(self) -> int:
        return {"resnet50": 2048, "vit_s16": 384, "vit_b16": 768}[self.model_name]

    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Config":
        d = dict(d)
        if isinstance(d.get("mae"), Mapping):
            d["mae"] = MAEConfig(**d["mae"])
        if isinstance(d.get("mesh"), Mapping):
            m = dict(d["mesh"])
            if isinstance(m.get("axis_names"), list):
                m["axis_names"] = tuple(m["axis_names"])
            d["mesh"] = MeshConfig(**m)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**d)

    @classmethod
    def from_file(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def with_overrides(self, overrides: Sequence[str]) -> "Config":
        """Apply ``key=value`` CLI overrides (dotted keys reach subconfigs)."""
        cfg_dict = self.to_dict()
        for item in overrides:
            key, _, raw = item.partition("=")
            if not _:
                raise ValueError(f"override {item!r} must be key=value")
            try:
                val = json.loads(raw)
            except json.JSONDecodeError:
                val = raw
            target = cfg_dict
            parts = key.split(".")
            for p in parts[:-1]:
                target = target[p]
            if parts[-1] not in target:
                raise ValueError(f"unknown config key {key!r}")
            target[parts[-1]] = val
        return Config.from_dict(cfg_dict)


def reference_py_config(**kw: Any) -> Config:
    """The reference's exact ``.py`` recipe (config.py + main.py defaults)."""
    base = Config(recipe="py", model_name="resnet50", trainable=True,
                  text_trainable=False, frozen_text_eval_mode=False)
    return base.replace(**kw)


def notebook_config(**kw: Any) -> Config:
    """The tutorial-notebook recipe (batch 32, per-tower LRs, 4 epochs)."""
    base = Config(recipe="notebook", batch_size=32, epochs=4,
                  text_trainable=True)
    return base.replace(**kw)


def flagship_tpu_config(**kw: Any) -> Config:
    """ViT-S/16 + DistilBERT joint CLIP+MAE recipe tuned for TPU v5e.
    (BASELINE.json configs 1-2: CLIP contrastive + joint MAE objective.)"""
    base = Config(
        recipe="py",
        model_name="vit_s16",
        image_embedding=384,
        batch_size=1024,
        compute_dtype="bfloat16",
        # CrossMAE-style decoder (arXiv:2401.14391): reconstruction quality
        # comparable to the full MAE decoder at ~25% fewer decoder tokens.
        # The MAE-paper-faithful decoder stays available via
        # mae.decoder_style='full'.
        mae=MAEConfig(enabled=True, decoder_style="cross"),
        global_contrastive=True,
        # From-scratch recipe: no pretrained weights to stay bit-compatible
        # with, so both towers use the cheap tanh GELU and MXU-width
        # (head_dim 128) attention heads (see the field docs above).
        gelu_impl="tanh",
        image_heads=3,
        text_heads=6,
    )
    return base.replace(**kw)


def flagship_siglip_config(**kw: Any) -> Config:
    """The flagship recipe with the SigLIP objective — the JAX package's
    recommended from-scratch configuration (its comparison with the
    softmax objective is in BASELINE.md and results/synth32k/RESULTS.md).
    lr 2e-4 (the preset-1e-3 collapse note applies to the softmax
    objective, but the same campaign lr is kept so arms stay comparable).
    """
    base = flagship_tpu_config(contrastive_loss="siglip", lr=2e-4)
    return base.replace(**kw)


def mae_pretrain_config(**kw: Any) -> Config:
    """Image-only MAE pretraining recipe (He et al., arXiv:2111.06377):
    masked reconstruction, no text tower. Base hyperparams follow the MAE
    paper's pretraining defaults (blr 1.5e-4, wd 0.05) at this family's
    flagship tower geometry; transfer the encoder into a CLIP run with
    ``cli train --init-from-mae`` (interop.transfer). For the paper's full
    schedule add ``lr_schedule='cosine'`` + ``warmup_steps`` (the CLI
    computes ``decay_steps`` from epochs when unset); the default stays
    ``constant`` so the preset is usable without a known step count."""
    base = Config(
        recipe="py",
        model_name="vit_s16",
        image_embedding=384,
        batch_size=1024,
        compute_dtype="bfloat16",
        mae=MAEConfig(enabled=True),
        lr=1.5e-4,
        weight_decay=0.05,
        gelu_impl="tanh",
        image_heads=3,
    )
    return base.replace(**kw)


def coco_full_config(**kw: Any) -> Config:
    """COCO-captions full training run (BASELINE.json config 3): the
    reference ``.py`` recipe at TPU-appropriate batch, COCO adapters."""
    base = reference_py_config(batch_size=256, compute_dtype="bfloat16",
                               debug=False)
    return base.replace(**kw)


def large_batch_mesh_config(**kw: Any) -> Config:
    """Large-batch global contrastive training on a multi-chip mesh
    (BASELINE.json config 5): 32k global batch, embedding all-gather over
    ICI, blockwise chunked loss so the 32k x 32k logits never materialize."""
    base = Config(
        recipe="py",
        model_name="vit_s16",
        image_embedding=384,
        batch_size=32768,
        compute_dtype="bfloat16",
        global_contrastive=True,
        loss_chunk_size=4096,
        # GradCache accumulation (see Config.accum_steps): 8 microbatches
        # of 4096 per chip-step keep activation memory at microbatch scale
        # while the contrastive objective stays the true 32k x 32k matrix.
        accum_steps=8,
        # LAMB (arXiv:1904.00962) — the standard large-batch optimizer.
        optimizer="lamb",
        remat=True,
        mesh=MeshConfig(data=-1, model=1),
        mae=MAEConfig(enabled=True),
    )
    return base.replace(**kw)
