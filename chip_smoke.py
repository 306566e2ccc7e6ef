#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``mae_clip_torch/csrc`` (one nvcc per
source, started together) and holds each kernel, forward and backward,
against its plain PyTorch version on the card (the attention pairs #1/#3
and #2/#4 also as training runs them: the forward writing the row
log-sum-exp, the backward reading it and the output; heads up to 256),
each template of the GEMM body that the block stacks share (every (layout,
epilogue) pair they launch, at cuts of their products and a ragged shape)
against the fp32 product with its epilogue in torch (and checks that a bf16
masked patch embedding at the pretrain shape runs that body with its
gathered rows alone), and the in-step augmentation against the CPU's. Then
it drives the port's paths through their entry points, each with the
kernels' launch counts set to 0 just before and read just after:

* serving (slice 1): the flagship model (ViT-S/16 + DistilBERT, random
  seeded weights, bf16) over HTTP, with the card's embeddings checked
  against the CPU's plain path;
* training (slice 2): the flagship CLIP+CrossMAE training step at batch 256
  (cached frozen-text features, uint8 patches normalised in the step, AdamW),
  checked for a falling loss, moving trainable and fixed frozen weights, and
  against one step on the CPU;
* MAE pretraining (slice 3): ``make_mae_pretrain_step`` on
  ``mae_pretrain_config`` at batch 256 (uint8 sources at 256 px cropped and
  flipped in the step, the MAE-paper decoder, the masked patch-embed kernel
  opted in), checked for exact launches per step, a falling loss, moving
  weights, evals that agree at one state, and against one step on the CPU;
* the fused block stacks (slice 4): the training step of slice 2 with
  ``fused_blocks='on'`` (the encoder and the CrossMAE decoder each one
  stack: kernel #6, which keeps each block's state, and #7, which reads it
  and recomputes nothing) and ``'fwd'`` (#6 with a per-block plain
  backward, no state), checked for exact launches and state buffers per
  step, a falling loss and moving weights, against one step on the CPU,
  and the serving tower (``encode_full``, no state) fused against per block
  on the card;
* the other options of the training step: ``flagship_siglip_config``'s
  step at batch 256 as the preset is (AdamW) and with LAMB, the cosine
  schedule, clipping and EMA, checked for exact launches, moving weights
  and a rising ``logit_bias``, with the update stage's device and host
  time and kernels; then, against the CPU at B=8, SigLIP, the hard-label
  loss with the learnable temperature, SigLIP with LAMB + cosine + clip +
  EMA over two steps (the card's optimizer also replayed on the CPU from
  its own gradients) and a trained text tower on tokens with padding
  masks (#2 / #4 in the text tower), and one step with attention dropout
  on the card, whose text tower takes the plain attention;
* the 32k-batch recipe: ``large_batch_mesh_config`` as the preset is, at
  batch 32,768 (GradCache over 8 microbatches of 4,096, the chunked
  soft-target loss at 4,096 columns, LAMB, per-block remat of the
  encoder, the MAE-paper decoder), checked for exact launches per step
  (#1 with the encoder's recompute), finite losses and moving weights,
  with its step time, busy share, stages and peak memory, and one
  microbatch's pass 2 with remat and without; then the chunked losses
  against the unchunked ones at 16,384 rows with their peak memory,
  GradCache against the one-pass step on the card, #1 giving the same
  bits twice (what remat's recompute needs), and the card's GradCache
  step against the CPU's one pass over the batch;
* the reference recipe: ``coco_full_config`` as the preset is (the
  ResNet-50 with train-mode BatchNorm, the frozen DistilBERT in train
  mode, AdamW, batch 256) on train and valid ``DeviceStore``s made on the
  card (deduped images, token tables): the bare step with its time,
  stages, peak memory and launches (none in the train step, #2 in the eval
  step) and the running statistics moved; ``Trainer.fit`` for two epochs
  with epoch and step checkpoints, the metric writer and a restore; a
  mid-epoch resume that must end bit for bit where the uninterrupted run
  does (deterministic cuDNN); one step at B=8 against the CPU; and the
  trained model served through ``RetrievalService`` against the CPU.

Last, it times each kernel at the training and pretraining shapes (and
#1 / #3 at the 32k recipe's encoder, 6 heads of 64) beside
its bound, its plain version and the PyTorch call that computes the same
thing (for the block stacks, which no single call computes, the port's own
per-block path on the same weights), and each of the stacks' bf16 products
alone on their GEMM body beside ``F.linear`` / ``torch.matmul``, and the
cast of the fp32 patches that runs in front of the masked patch embedding.
Any failed check raises, so the run exits non-zero. The last line of standard output is
``{"ok": true, "device": {...}}``; before it come the ``{"kernels": [...]}``
summary and the card's name and power limit.

It imports nothing of JAX and nothing of the JAX package. It exits non-zero,
printing no result, when no CUDA card is present.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM rate, dense bf16 tensor rate, and
# fp32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

DEVICE = torch.device("cuda")
FP32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_ATOL = 2e-2


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def clock_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ---------------------------------------------------------------------------
# Phase 1: build
# ---------------------------------------------------------------------------

def build_kernels() -> None:
    from mae_clip_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"built {len(paths)} kernel source(s) in "
        f"{time.perf_counter() - t0:.1f} s")
    for src in paths:
        for line in _build.ptxas_report(src).splitlines():
            entry = re.search(r"Compiling entry function '.*?\d+"
                              r"([a-z][a-z_]*_kernel)(I[^']*)?'", line)
            if entry:
                args = re.findall(r"L[bi](\d+)E", entry.group(2) or "")
                dim = f"<{','.join(args)}>" if args else ""
                log(f"  {src}: {entry.group(1)}{dim}")
            elif ("registers" in line or "spill" in line or "smem" in line
                  or "warning" in line.lower()):
                log(f"  {src}: {line.strip()}")
    _build.load_attention()
    _build.load_attention_bwd()
    _build.load_patch_embed()
    _build.load_block_stack_fwd()
    _build.load_block_stack_bwd()


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def _close(name: str, got: torch.Tensor, want: torch.Tensor, atol: float,
           rtol: float = 0.0) -> float:
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    max_err = float(err.max())
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements out of "
                             f"tolerance, max abs err {max_err:.3e}")
    return max_err


def _padding_mask(gen: torch.Generator, b: int, s: int, dev) -> torch.Tensor:
    """(b, s) float mask with a random valid prefix of 1..s keys per row."""
    lens = torch.randint(1, s + 1, (b,), generator=gen)
    return (torch.arange(s)[None, :] < lens[:, None]).float().to(dev)


def check_kernels() -> dict:
    """Every kernel vs its plain version on the card; returns the largest
    abs error seen per kernel."""
    from mae_clip_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    worst = {"qkv_packed_attention": 0.0, "flash_attention": 0.0}

    def run(name, fn, ref, make):
        """``make(dtype)`` gives the inputs, floating tensors in ``dtype``."""
        for dt in (torch.float32, torch.bfloat16):
            xs = make(dt)
            got = fn(*xs)
            torch.cuda.synchronize()
            want = ref(*[x.float() if x is not None and x.dim() > 2 else x
                         for x in xs])
            if dt == torch.float32:
                err = _close(f"{name} fp32", got, want, **FP32_TOL)
            else:
                err = _close(f"{name} bf16", got, want, BF16_ATOL)
            worst[name] = max(worst[name], err)
            log(f"  {name} {str(dt)[6:]} {tuple(xs[0].shape)}: "
                f"max abs err {err:.3e}")

    # Packed qkv: the ViT-S/16 flagship block (3 heads of 128, S=197) at
    # B=64, the training step's masked encoder pass (CLS + 49 visible
    # tokens) at B=256 with no mask, the MAE-paper decoder (CLS + 196
    # tokens, 2 heads of 128) at B=256, a padding mask at S=50, and heads
    # of 256 (the scalar bodies) at S=50 and S=197.
    for b, s, h, masked, d in ((64, 197, 3, False, 128),
                               (256, 50, 3, False, 128),
                               (256, 197, 2, False, 128),
                               (8, 50, 3, True, 128), (8, 50, 2, True, 256),
                               (4, 197, 3, True, 256)):
        qkv = torch.randn(b, s, 3 * h * d, generator=gen).to(dev)
        kv = _padding_mask(gen, b, s, dev) if masked else None
        run("qkv_packed_attention",
            lambda x, m, h=h: A.qkv_packed_attention(x, m, h),
            lambda x, m, h=h: A.qkv_packed_attention_ref(x, m, h),
            lambda dt, qkv=qkv, kv=kv: [qkv.to(dt), kv])

    # Flash: DistilBERT at serving (B=16, 6 heads of 128, S=64, padding
    # mask) with the head split as a strided view of a linear output, the
    # CrossMAE decoder's cross-attention at the training step's B=256 (Sq=147,
    # Sk=50, 2x128, no mask) in its own layout, and S=300 for several key
    # tiles. Each case also as training runs #2, writing the row
    # log-sum-exp: out and lse against the plain (out, lse) forward.
    def flash_case(b, h, sq, sk, masked, layout, d=128):
        kv = _padding_mask(gen, b, sk, dev) if masked else None
        if layout == "decoder":
            # q a (B, Sq, H, Dh) view; k/v the halves of one (B, Sk, 2, H, Dh)
            # projection output, as CrossAttnBlock splits them (no copy).
            q0 = torch.randn(b, sq, h, d, generator=gen).to(dev)
            kv0 = torch.randn(b, sk, 2, h, d, generator=gen).to(dev)

            def make(dt):
                kvt = kv0.to(dt)
                return [q0.to(dt).transpose(1, 2),
                        kvt[:, :, 0].transpose(1, 2),
                        kvt[:, :, 1].transpose(1, 2), kv]
        else:
            strided = layout == "strided"  # (B, S, H, Dh) seen as (B, H, S, Dh)
            xs = [torch.randn(*((b, n, h, d) if strided else (b, h, n, d)),
                              generator=gen).to(dev) for n in (sq, sk, sk)]

            def make(dt):
                return [x.to(dt).transpose(1, 2) if strided else x.to(dt)
                        for x in xs] + [kv]
        run("flash_attention", A.flash_attention, A.flash_attention_ref, make)
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, _ = make(dt)
            out, lse = A._launch_flash(
                q, k, v, A._mask_arg(kv, b, sk, q.device), d ** -0.5,
                with_lse=True)
            torch.cuda.synchronize()
            want, want_lse = A.flash_attention_lse_ref(q.float(), k.float(),
                                                       v.float(), kv)
            tol = FP32_TOL if dt == torch.float32 else dict(atol=BF16_ATOL)
            label = (f"q ({b},{h},{sq},{d}) k/v ({b},{h},{sk},{d}) {layout}"
                     f"{' masked' if masked else ''}")
            err = _close(f"flash_attention lse path {str(dt)[6:]} {label}",
                         out, want, **tol)
            lse_err = _close(f"flash_attention lse {str(dt)[6:]} {label}",
                             lse, want_lse, **FP32_TOL)
            worst["flash_attention"] = max(worst["flash_attention"], err)
            log(f"  flash_attention with lse {str(dt)[6:]} {label}: max abs "
                f"err out {err:.3e}, lse {lse_err:.3e}")

    # #1 as the training path runs it, writing the row log-sum-exp, at the
    # two main shapes (the CLIP/MAE encoder, the MAE-paper decoder), with a
    # padding mask, and at head dim 64 (a ViT-B head; its own template
    # bodies) at S <= 64 and above: out and lse against the plain (out, lse)
    # forward.
    for b, s, h, masked, d in ((256, 50, 3, False, 128),
                               (256, 197, 2, False, 128),
                               (8, 197, 2, True, 128), (16, 50, 4, True, 64),
                               (8, 197, 4, True, 64), (8, 50, 2, True, 256),
                               (4, 197, 3, True, 256)):
        qkv = torch.randn(b, s, 3 * h * d, generator=gen).to(dev)
        kv = _padding_mask(gen, b, s, dev) if masked else None
        for dt in (torch.float32, torch.bfloat16):
            x = qkv.to(dt)
            out, lse = A._launch_packed(x, A._mask_arg(kv, b, s, x.device), h,
                                        d ** -0.5, with_lse=True)
            torch.cuda.synchronize()
            want, want_lse = A.qkv_packed_attention_lse_ref(x.float(), kv, h)
            tol = FP32_TOL if dt == torch.float32 else dict(atol=BF16_ATOL)
            err = _close(f"qkv_packed_attention lse path {str(dt)[6:]}", out,
                         want, **tol)
            lse_err = _close(f"qkv_packed_attention lse {str(dt)[6:]}", lse,
                             want_lse, **FP32_TOL)
            worst["qkv_packed_attention"] = max(
                worst["qkv_packed_attention"], err)
            log(f"  qkv_packed_attention with lse {str(dt)[6:]} "
                f"({b},{s},{3 * h * d}){' masked' if masked else ''}: "
                f"max abs err out {err:.3e}, lse {lse_err:.3e}")

    for case in FLASH_CASES:
        flash_case(*case)
    return worst


# (B, H, Sq, Sk, masked, layout, Dh) of the flash checks, forward and
# backward: DistilBERT at serving (strided head views and plain), the
# CrossMAE decoder (147 queries on 50 keys, its split views; one key tile
# and many query tiles: #2's and #4's streaming bodies), S=300 (several
# tiles each way), Sk <= 64 < Sq with a ragged last stage, and other head
# dims: 64 (tensor-core bodies), 80 (the scalar bodies, which also serve
# fp32 and unaligned strides) and 256 (the scalar bodies' wide instances;
# DistilBERT with 3 heads); and the reference recipe's eval and serving
# text tower (DistilBERT's 12 heads of 64, S=200, strided, padding mask).
FLASH_CASES = ((16, 6, 64, 64, True, "strided", 128),
               (16, 6, 64, 64, True, "plain", 128),
               (256, 2, 147, 50, False, "decoder", 128),
               (8, 2, 147, 50, True, "decoder", 64),
               (4, 2, 70, 13, True, "plain", 128),
               (2, 2, 300, 300, True, "plain", 128),
               (4, 2, 77, 77, True, "plain", 64),
               (2, 3, 33, 40, True, "plain", 80),
               (16, 3, 64, 64, True, "strided", 256),
               (4, 2, 147, 50, True, "decoder", 256),
               (256, 12, 200, 200, True, "strided", 64))


def _bwd_close(name: str, got, want, dtype) -> float:
    """fp32: atol 1e-4 / rtol 1e-4. bf16, against the plain version in fp32
    on the same bf16 values: max abs error <= 2e-2 * max(1, max |plain|)."""
    if dtype == torch.float32:
        return _close(name, got, want, **FP32_TOL)
    return _close(name, got, want,
                  BF16_ATOL * max(1.0, float(want.abs().max())))


def check_backward_kernels(worst: dict) -> None:
    """The backward kernels against their plain backward versions on the
    card, fp32 and bf16, TF32 off. One case of each goes through
    torch.autograd.grad of the wrapper; the others call the raw entry."""
    from mae_clip_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = DEVICE
    gen = torch.Generator().manual_seed(5)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    def check(name, label, got, want, dt):
        errs = [_bwd_close(f"{name} {label} {str(dt)[6:]}", x, y, dt)
                for x, y in zip(got, want)]
        worst[name] = max(worst.get(name, 0.0), *errs)
        top = max(float(y.abs().max()) for y in want)
        log(f"  {name} {str(dt)[6:]} {label}: max abs err {max(errs):.3e} "
            f"(max |plain| {top:.3e})")

    # Packed (kernel #3), from the forward's out and lse: the step's encoder
    # shape, the MAE-paper decoder's (2 heads, S=197: several query and key
    # tiles), a padding mask at S=50, S=197 through autograd, and head dims
    # 64 and 256 with a padding mask at S <= 64 (one kernel at 64) and above
    # (two). Held against the plain backward that recomputes the statistics
    # (as the TPU kernel does) and against the one that takes the kernel's
    # out and lse.
    for b, s, h, masked, autograd, d in ((256, 50, 3, False, False, 128),
                                         (256, 197, 2, False, False, 128),
                                         (8, 50, 3, True, False, 128),
                                         (16, 197, 3, True, True, 128),
                                         (16, 50, 4, True, False, 64),
                                         (8, 197, 4, True, False, 64),
                                         (8, 50, 2, True, False, 256),
                                         (4, 197, 3, True, True, 256)):
        qkv0, g0 = randn(b, s, 3 * h * d), randn(b, s, h * d)
        kv = _padding_mask(gen, b, s, dev) if masked else None
        for dt in (torch.float32, torch.bfloat16):
            qkv, g = qkv0.to(dt), g0.to(dt)
            mask = A._mask_arg(kv, b, s, qkv.device)
            out, lse = A._launch_packed(qkv, mask, h, d ** -0.5,
                                        with_lse=True)
            if autograd:
                x = qkv.clone().requires_grad_()
                got = torch.autograd.grad(A.qkv_packed_attention(x, kv, h),
                                          x, g)
            else:
                got = (A._launch_packed_bwd(qkv, mask, h, d ** -0.5, out,
                                            lse, g),)
            torch.cuda.synchronize()
            label = (f"({b},{s},{3 * h * d}){' masked' if masked else ''}"
                     f"{' autograd' if autograd else ''}")
            want = (A.qkv_packed_attention_bwd_ref(qkv.float(), kv, h, None,
                                                   g.float()),)
            check("qkv_packed_attention_bwd", label, got, want, dt)
            want = (A.qkv_packed_attention_bwd_lse_ref(
                qkv.float(), kv, h, None, out.float(), lse, g.float()),)
            check("qkv_packed_attention_bwd", label + " vs the lse plain",
                  got, want, dt)

    # Flash (kernel #4) from #2's output and lse, at every flash case of
    # the forward checks (FLASH_CASES), the decoder's through autograd; the
    # masked cases with more than 64 queries also with row 0's keys all
    # masked. Held against the plain backward that recomputes the
    # statistics and against the one that takes the output and lse.
    def flash_inputs(dt, b, h, sq, sk, d, layout):
        if layout == "decoder":  # q of (B, Sq, H, Dh); k/v of (B, Sk, 2, H, Dh)
            q = randn(b, sq, h, d).to(dt).transpose(1, 2)
            kv = randn(b, sk, 2, h, d).to(dt)
            return q, kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
        if layout == "strided":  # (B, S, H, Dh) storage seen as (B, H, S, Dh)
            return tuple(randn(b, n, h, d).to(dt).transpose(1, 2)
                         for n in (sq, sk, sk))
        return tuple(randn(b, h, n, d).to(dt) for n in (sq, sk, sk))

    for b, h, sq, sk, masked, layout, d in FLASH_CASES:
        kv, kind = None, ""
        if masked:
            kv, kind = _padding_mask(gen, b, sk, dev), " padding mask"
            if sq > 64:
                kv[0], kind = 0, " padding mask, row 0 fully masked"
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(dt, b, h, sq, sk, d, layout)
            g = randn(b, sq, h, d).to(dt).transpose(1, 2)
            mask = A._mask_arg(kv, b, sk, q.device)
            out, lse = A._launch_flash(q, k, v, mask, d ** -0.5,
                                       with_lse=True)
            if layout == "decoder":
                xs = [t.detach().requires_grad_() for t in (q, k, v)]
                got = torch.autograd.grad(A.flash_attention(*xs, kv), xs, g)
            else:
                got = A._launch_flash_bwd(q, k, v, mask, d ** -0.5, out, lse,
                                          g)
            torch.cuda.synchronize()
            plain = [t.float() for t in (q, k, v)]
            label = (f"q ({b},{h},{sq},{d}) k/v ({b},{h},{sk},{d}) {layout}"
                     f"{kind}{' autograd' if layout == 'decoder' else ''}")
            check("flash_attention_bwd", label, got,
                  A.flash_attention_bwd_ref(*plain, kv, None, g.float()), dt)
            check("flash_attention_bwd", label + " vs the lse plain", got,
                  A.flash_attention_bwd_lse_ref(*plain, kv, None, out.float(),
                                                lse, g.float()), dt)


# (B, S, H, Dh) of the 32k recipe's microbatch of 4,096 (phase 14): the
# ViT-S/16 encoder's 6 heads of 64 and the MAE-paper decoder's 2 of 128.
LARGE_BATCH_ATTENTION = ((4096, 50, 6, 64), (4096, 197, 2, 128))


def check_large_batch_attention(worst: dict,
                                shapes=LARGE_BATCH_ATTENTION) -> None:
    """#1 and #3 in bf16 at the large-batch path's shapes (B*H up to
    24,576 blocks in y), inputs made on the card: #1 without lse (pass 1)
    against the plain forward, with lse twice on the same qkv (remat
    recomputes a block and #3 reads the recomputed out and lse against
    gradients from the first forward, so the two must be the same bits),
    out and lse against the plain (out, lse) forward; #3 from that out and
    lse against both plain backwards, at ``_bwd_close``'s limit."""
    from mae_clip_torch.ops import attention as A

    gen = torch.Generator(device=DEVICE).manual_seed(13)
    for b, s, h, d in shapes:
        qkv, g = (torch.randn(b, s, n * h * d, device=DEVICE, generator=gen,
                              dtype=torch.bfloat16) for n in (3, 1))
        label = f"({b},{s},{3 * h * d}) {h} heads of {d} bf16"
        plain, plain_lse = A.qkv_packed_attention_lse_ref(qkv.float(), None, h)
        first = A._launch_packed(qkv, None, h, d ** -0.5, with_lse=True)
        again = A._launch_packed(qkv, None, h, d ** -0.5, with_lse=True)
        no_lse = A._launch_packed(qkv, None, h, d ** -0.5)[0]
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(first, again))
        log(f"  #1 with lse twice at {label}: the same bits {same}")
        if not same:
            raise AssertionError(f"#1 is not deterministic at {label}")
        errs = [_close(f"qkv_packed_attention {label}", no_lse, plain,
                       BF16_ATOL),
                _close(f"qkv_packed_attention lse path {label}", first[0],
                       plain, BF16_ATOL)]
        lse_err = _close(f"qkv_packed_attention lse {label}", first[1],
                         plain_lse, **FP32_TOL)
        worst["qkv_packed_attention"] = max(worst["qkv_packed_attention"],
                                            *errs)
        log(f"  qkv_packed_attention {label}: max abs err out {errs[0]:.3e}, "
            f"with lse {errs[1]:.3e}, lse {lse_err:.3e}")
        del plain, plain_lse, again, no_lse
        out, lse = first
        got = A._launch_packed_bwd(qkv, None, h, d ** -0.5, out, lse, g)
        torch.cuda.synchronize()
        for what, want in (
                ("", A.qkv_packed_attention_bwd_ref(qkv.float(), None, h,
                                                    None, g.float())),
                (" vs the lse plain", A.qkv_packed_attention_bwd_lse_ref(
                    qkv.float(), None, h, None, out.float(), lse,
                    g.float()))):
            err = _bwd_close(f"qkv_packed_attention_bwd {label}{what}", got,
                             want, torch.bfloat16)
            worst["qkv_packed_attention_bwd"] = max(
                worst.get("qkv_packed_attention_bwd", 0.0), err)
            log(f"  qkv_packed_attention_bwd {label}{what}: max abs err "
                f"{err:.3e} (max |plain| {float(want.abs().max()):.3e})")
            del want
        del qkv, g, first, out, lse, got
        gc.collect()
        torch.cuda.empty_cache()


# The MAE-pretrain step's masked patch embedding: (B, N, Din) patches,
# K visible rows, Dm outputs.
PATCH_EMBED_SHAPE = (256, 196, 768, 49, 384)
# Held against the plain version besides: the tensor-core body with a ragged
# M tile (M = 145), a last K stage partly past Din and a ragged N tile; an
# odd shape with a ragged row tile; widths that are not multiples of 8 (the
# scalar body, in bf16 too).
PATCH_EMBED_CHECKS = ((5, 40, 200, 29, 136), (3, 20, 48, 7, 40),
                      (2, 9, 30, 5, 13))
# The launch breakdown's group of #5's bf16 body (_kernel_group): the
# stacks' tensor-core GEMM body with the gathered A.
PATCH_EMBED_BODY = "GEMM wgmma<gather,nk,bias>"


def _patch_embed_inputs(gen, shape, dtype):
    b, n, d_in, k, d_m = shape
    patches = torch.randn(b, n, d_in, generator=gen)
    ids = torch.argsort(torch.rand(b, n, generator=gen), dim=1)[:, :k]
    w = torch.randn(d_m, d_in, generator=gen) * d_in ** -0.5
    bias = torch.randn(d_m, generator=gen) * 0.02
    return (patches.to(DEVICE, dtype), ids.to(DEVICE), w.to(DEVICE, dtype),
            bias.to(DEVICE, dtype))


def check_patch_embed_kernel(worst: dict) -> None:
    """Kernel #5 against its plain version on the card, fp32 and bf16, at
    the pretrain step's shape and at ``PATCH_EMBED_CHECKS``, and once
    through autograd (its backward is plain torch). A traced bf16 call at
    the pretrain step's shape must run the tensor-core body alone."""
    from mae_clip_torch.ops import patch_embed as PE

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(6)
    name = "masked_patch_embed"
    worst[name] = 0.0
    for shape in (PATCH_EMBED_SHAPE, *PATCH_EMBED_CHECKS):
        for dt in (torch.float32, torch.bfloat16):
            p, ids, w, b = _patch_embed_inputs(gen, shape, dt)
            got = PE.masked_patch_embed(p, ids, w, b)
            torch.cuda.synchronize()
            want = PE.masked_patch_embed_ref(p.float(), ids, w.float(),
                                             b.float())
            err = _bwd_close(f"{name} {str(dt)[6:]} {shape}", got, want, dt)
            worst[name] = max(worst[name], err)
            log(f"  {name} {str(dt)[6:]} {shape}: max abs err {err:.3e}")
    p, ids, w, b = _patch_embed_inputs(gen, PATCH_EMBED_SHAPE, torch.bfloat16)
    g = torch.randn(*ids.shape, w.shape[0], generator=gen).to(DEVICE,
                                                               torch.bfloat16)
    xs = [t.clone().requires_grad_() for t in (p, w, b)]
    ys = [t.float().clone().requires_grad_() for t in (p, w, b)]
    got = torch.autograd.grad(PE.masked_patch_embed(xs[0], ids, *xs[1:]),
                              xs, g)
    want = torch.autograd.grad(PE.masked_patch_embed_ref(ys[0], ids, *ys[1:]),
                               ys, g.float())
    torch.cuda.synchronize()
    errs = [_bwd_close(f"{name} autograd d{n}", x, y, torch.bfloat16)
            for n, x, y in zip(("patches", "W", "b"), got, want)]
    log(f"  {name} bf16 {PATCH_EMBED_SHAPE} autograd: max abs err of the "
        f"gradients {max(errs):.3e}")
    window = profile_window(lambda: PE.masked_patch_embed(p, ids, w, b),
                            top=0, names=True)
    groups = {_kernel_group(k): n for k, (_, n) in
              window["kernels_by_name"].items()}
    log(f"  {name} bf16 {PATCH_EMBED_SHAPE}: kernels of one traced call "
        f"{groups}")
    if set(groups) != {PATCH_EMBED_BODY}:
        raise AssertionError(f"{name}: a bf16 call at {PATCH_EMBED_SHAPE} ran "
                             f"{groups}, not the tensor-core body alone "
                             f"({PATCH_EMBED_BODY})")


# Block stacks (B, Sq, Sk, D, H, F, L, cross) held against the plain
# versions, each in the dtypes listed: the main paths' own shapes at full
# batch and depth (the fused training step's ViT-S/16 encoder and CrossMAE
# decoder, and the fused serving tower over 64 images at S=197), then cut
# shapes for the fp32 bodies at serving's length and the decoder's, and odd
# lengths at the smallest legal width. Tolerances, for the output, qstack,
# #6's state, dq0, dkv and all 16 weight gradients: fp32 max abs error
# <= 1e-4 * max(1, max |plain|), bf16 <= 2e-2 * max(1, max |plain|).
# Every block of the kernel's run is held to them on its own input (the
# plain block on the kernel's input to that block: its output and its
# state), and #6 must give the same bits with a state buffer as without.
# #7 is held against the plain backward from the same qstack and state
# (#6's, viewed by state_views), over the whole stack. The whole bf16 stack is
# held to them end to end where the plain version run on the CPU (other
# fp32 sum orders, the same roundings) meets them against the plain version
# on the card; over 12 bf16 blocks it need not, since rounding flips
# compound with depth. Both errors are logged.
STACK_CHECKS = (
    ((256, 50, 50, 384, 3, 1536, 12, False), (torch.float32, torch.bfloat16)),
    ((256, 147, 50, 256, 2, 1024, 4, True), (torch.bfloat16,)),
    ((64, 197, 197, 384, 3, 1536, 12, False), (torch.bfloat16,)),
    ((16, 197, 197, 384, 3, 1536, 2, False), (torch.float32,)),
    ((32, 147, 50, 256, 2, 1024, 2, True), (torch.float32, torch.bfloat16)),
    ((2, 9, 5, 128, 1, 256, 2, True), (torch.float32, torch.bfloat16)),
    # Heads of 256, self and cross (the attention bodies' wide instances).
    ((8, 50, 50, 512, 2, 2048, 2, False), (torch.float32, torch.bfloat16)),
    ((8, 147, 50, 512, 2, 2048, 2, True), (torch.float32, torch.bfloat16)))
STACK_FP32_TOL = 1e-4


def _stack_inputs(gen, shape, dtype):
    """q0, kv (q0 in self mode), stacked weights in torch's layout (0.05 *
    normal, LN scales 1 + 0.05 * normal) and an output gradient."""
    b, sq, sk, d, _, f, n, cross = shape

    def r(*sh, scale=0.05, one=0.0):
        return (one + torch.randn(*sh, generator=gen) * scale).to(DEVICE,
                                                                  dtype)

    w = {"ln1_g": r(n, d, one=1.0), "ln1_b": r(n, d),
         "lnkv_g": r(n, d, one=1.0), "lnkv_b": r(n, d), "wq": r(n, d, d),
         "bq": r(n, d), "wkv": r(n, 2 * d, d), "bkv": r(n, 2 * d),
         "wproj": r(n, d, d), "bproj": r(n, d), "ln2_g": r(n, d, one=1.0),
         "ln2_b": r(n, d), "wfc1": r(n, f, d), "bfc1": r(n, f),
         "wfc2": r(n, d, f), "bfc2": r(n, d)}
    q0 = r(b, sq, d, scale=1.0)
    kv = r(b, sk, d, scale=1.0) if cross else q0
    return q0, kv, w, r(b, sq, d, scale=1.0)


def check_block_stack_kernels(worst: dict) -> None:
    """Kernels #6 and #7 against fused_block_stack_ref / _bwd_ref on the
    card, fp32 and bf16, TF32 off, #7 and the plain backward both from #6's
    state; then one bf16 pass through autograd."""
    from mae_clip_torch.ops import block_kernel as BK

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(9)
    worst["fused_block_stack"] = worst["fused_block_stack_bwd"] = 0.0

    def tol(want, dt):
        scale = max(1.0, float(want.abs().max()))
        return (STACK_FP32_TOL if dt == torch.float32 else BF16_ATOL) * scale

    for shape, dtypes in STACK_CHECKS:
        h, n, cross = shape[4], shape[6], shape[7]
        for dt in dtypes:
            label = f"{str(dt)[6:]} {shape}"
            q0, kv, w, dout = _stack_inputs(gen, shape, dt)
            want_out, want_qstack = BK.fused_block_stack_ref(
                q0, kv, w, h, "tanh", cross)
            out, qstack, state = BK._launch_fwd(q0, kv, w, h, "tanh", cross,
                                                keep_state=True)
            bare = BK._launch_fwd(q0, kv, w, h, "tanh", cross)
            torch.cuda.synchronize()
            if not (torch.equal(out, bare[0])
                    and torch.equal(qstack, bare[1])):
                raise AssertionError(f"fused_block_stack {label}: other "
                                     "bits with a state buffer than without")
            del bare
            views = BK.state_views(state, qstack, kv, w, h, cross)
            # #7 and its plain version from the same qstack and state.
            got = BK._launch_bwd(qstack, kv, w, dout, state, h, "tanh", cross)
            torch.cuda.synchronize()
            want = BK.fused_block_stack_bwd_ref(qstack, kv, w, dout, h,
                                                "tanh", cross, state=views)
            errs, serrs = [], []
            for l in range(n):
                x, wl = qstack[l], {k: v[l:l + 1] for k, v in w.items()}
                want_l, _, want_st = BK.fused_block_stack_ref(
                    x, kv if cross else x, wl, h, "tanh", cross,
                    keep_state=True)
                errs.append(_close(f"fused_block_stack {label} block {l}",
                                   qstack[l + 1] if l + 1 < n else out,
                                   want_l, tol(want_l, dt)))
                serrs += [_close(f"fused_block_stack {label} block {l} "
                                 f"state {k}", views[l][k], y, tol(y, dt))
                          for k, y in want_st[0].items() if y is not None]
            whole = (("out", out, want_out), ("qstack", qstack, want_qstack))
            held, drift = True, ""
            if dt == torch.bfloat16 and n > 2:
                cpu_out, cpu_qstack = BK.fused_block_stack_ref(
                    q0.cpu(), kv.cpu(), {k: v.cpu() for k, v in w.items()}, h,
                    "tanh", cross)
                d = [_close("plain on the CPU", a, y.cpu(), math.inf)
                     for a, y in ((cpu_out, want_out),
                                  (cpu_qstack, want_qstack))]
                held = all(e <= tol(y, dt) for e, (_, _, y) in zip(d, whole))
                drift = (f"; plain on the CPU vs on the card {max(d):.3e}, "
                         f"end to end {'held' if held else 'not held'}")
            whole_errs = [_close(f"fused_block_stack {label} {what}", x, y,
                                 tol(y, dt) if held else math.inf)
                          for what, x, y in whole]
            worst["fused_block_stack"] = max(worst["fused_block_stack"],
                                             *errs, *serrs, *whole_errs)
            pairs = [("dq0", got[0], want[0])]
            if cross:
                pairs.append(("dkv", got[1], want[1]))
            pairs += [(k, got[2][k], want[2][k]) for k in BK.W_KEYS]
            berrs = [_close(f"fused_block_stack_bwd {label} {k}", x, y,
                            tol(y, dt)) for k, x, y in pairs]
            worst["fused_block_stack_bwd"] = max(
                worst["fused_block_stack_bwd"], *berrs)
            i = int(np.argmax(berrs))
            ctx_delta = ""
            if dt == torch.bfloat16:
                # The bf16 body takes the row sum from the forward's rounded
                # ctx, not from P * dP: held also against a plain version
                # that does the same, to show what that choice moves.
                want_c = BK.fused_block_stack_bwd_ref(
                    qstack, kv, w, dout, h, "tanh", cross,
                    delta_from_ctx=True, state=views)
                pairs_c = [("dq0", want_c[0]), ("dkv", want_c[1])][
                    :1 + cross] + [(k, want_c[2][k]) for k in BK.W_KEYS]
                cerrs = [_close(f"fused_block_stack_bwd {label} {k} vs the "
                                "row sum from ctx", x, y, tol(y, dt))
                         for (k, x, _), (_, y) in zip(pairs, pairs_c)]
                ctx_delta = (f"; against the plain version taking the row "
                             f"sum from ctx {max(cerrs):.3e} "
                             f"({pairs[int(np.argmax(cerrs))][0]})")
            log(f"  fused_block_stack {label}: max abs err forward per block "
                f"{max(errs):.3e}, its state {max(serrs):.3e}, end to end "
                f"{max(whole_errs):.3e}{drift}; the same bits with and "
                f"without the state ({state.numel() / 1e9:.3f} GB); "
                f"backward from it {max(berrs):.3e} (dq0, "
                f"{'dkv, ' if cross else ''}16 dw; the largest in "
                f"{pairs[i][0]}, at a limit of {tol(pairs[i][2], dt):.3e})"
                f"{ctx_delta}")

    shape = (32, 147, 50, 256, 2, 1024, 2, True)
    q0, kv, w, dout = _stack_inputs(gen, shape, torch.bfloat16)
    xs = [t.clone().requires_grad_() for t in (q0, kv)]
    ws = {k: v.clone().requires_grad_() for k, v in w.items()}
    got = torch.autograd.grad(BK.fused_block_stack(xs[0], xs[1], ws, 2),
                              xs + list(ws.values()), dout)
    torch.cuda.synchronize()
    want_q, want_kv, want_w = BK.fused_block_stack_bwd_ref(
        BK.fused_block_stack_ref(q0, kv, w, 2)[1], kv, w, dout, 2)
    errs = [_close(f"fused_block_stack autograd {k}", x, y,
                   tol(y, torch.bfloat16))
            for k, x, y in zip(("dq0", "dkv") + BK.W_KEYS, got,
                               [want_q, want_kv] + [want_w[k]
                                                    for k in BK.W_KEYS])]
    log(f"  fused_block_stack bf16 {shape} autograd: max abs err of the "
        f"gradients {max(errs):.3e}")


# The stacks' bf16 products, each run by the GEMM body that #6 and #7 share
# (csrc/block_common.cuh), alone: per block of #6 the five forward products,
# per block of #7 the five input gradients and the five weight gradients'
# split partials, at a stack shape (B, Sq, Sk, D, H, F, L, cross).
def stack_gemms(shape) -> list:
    b, sq, sk, d, _, f, n, cross = shape
    m, mk = b * sq, b * (sk if cross else sq)
    fwd = (("q", "bias", m, d, d), ("kv", "bias", mk, 2 * d, d),
           ("proj", "bias_res", m, d, d), ("fc1", "bias_gelu", m, f, d),
           ("fc2", "bias_res", m, d, f))
    dx = (("fc2", "gelu_grad", m, f, d), ("fc1", "f32", m, d, f),
          ("proj", "round", m, d, d), ("q", "f32", m, d, d),
          ("kv", "f32" if cross else "f32_add", mk, d, 2 * d))
    dw = (("fc2", d, f, m), ("fc1", f, d, m), ("proj", d, d, m),
          ("q", d, d, m), ("kv", 2 * d, d, mk))
    return ([dict(kernel="fused_block_stack", name=f"{w} forward",
                  pair=("mk", "nk", mode), m=rows, n=cols, k=k, per_call=n)
             for w, mode, rows, cols, k in fwd]
            + [dict(kernel="fused_block_stack_bwd", name=f"{w} input grad",
                    pair=("mk", "kn", mode), m=rows, n=cols, k=k, per_call=n)
               for w, mode, rows, cols, k in dx]
            + [dict(kernel="fused_block_stack_bwd", name=f"{w} weight grad",
                    pair=("km", "kn", "partial"), m=o, n=i, k=rows,
                    per_call=n)
               for w, o, i, rows in dw])


# Each template of the body is held against the fp32 product of the same
# bf16 operands with its epilogue written in torch (gemm_body_ref), at a
# cut of each main product (its rows cut to GEMM_CUT_ROWS: M, or K for the
# weight gradients, whose row splits are then #7's own) and at a ragged
# shape (no dim a multiple of 64; 3 splits for the partials). fp32 outputs
# within 1e-3 * max(1, max |ref|) (only the order of the sums differs);
# bf16 outputs within one bf16 step of the reference rounded the same way,
# one step per rounding in the output's chain, carried through it
# (bias_res: the step of round(acc + bias) and of the output; bias_gelu's
# GELU: 1.2 steps of a1, GELU's largest slope being 1.13, and one of the
# output), plus the fp32 sums' order carried the same way: 2^-16 *
# sum_k |a_mk b_kn| (the sums differ by ~2^-24 of it; this shows only
# where a sum cancels, and a bf16 step no longer covers its fp32 error).
GEMM_CUT_ROWS = 1024
GEMM_RAGGED = (200, 24, 40)
GEMM_FP32_TOL = 1e-3
GEMM_SUM_ORDER = 2.0 ** -16


def gemm_check_shapes(pair) -> list:
    """(M, N, K, splits or None for #7's own) of the check of one pair."""
    shapes = []
    for shape in STACK_SHAPES.values():
        for g in stack_gemms(shape):
            if g["pair"] == pair:
                m, n, k = g["m"], g["n"], g["k"]
                if pair[2] == "partial":
                    k = GEMM_CUT_ROWS
                else:
                    m = GEMM_CUT_ROWS
                if (m, n, k, None) not in shapes:
                    shapes.append((m, n, k, None))
    return shapes + [GEMM_RAGGED + (3 if pair[2] == "partial" else 1,)]


def _gemm_inputs(gen, pair, m: int, n: int, k: int, device=None):
    """bf16 operands stored in the pair's layouts (activations normal, a
    weight normal / sqrt(K); both normal for the weight gradients), the
    bias, residual and GELU input its epilogue reads, and the fp32 outf an
    f32_add adds into."""
    device = device or DEVICE
    a_km, b_kn, mode = pair[0] == "km", pair[1] == "kn", pair[2]

    def r(*sh, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*sh, generator=gen) * scale).to(device, dtype)

    a = r(k, m) if a_km else r(m, k)
    scale = 1.0 if mode == "partial" else k ** -0.5
    b = r(k, n, scale=scale) if b_kn else r(n, k, scale=scale)
    return dict(a=a, b=b,
                bias=r(n, scale=0.1) if mode.startswith("bias") else None,
                res=r(m, n) if mode == "bias_res" else None,
                aux=r(m, n) if mode == "gelu_grad" else None,
                outf=(r(m, n, dtype=torch.float32) if mode == "f32_add"
                      else None))


def _bf16_step(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 (8 significant bits) at each |x|."""
    _, e = torch.frexp(x.float().abs())
    step = torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8)
    return torch.where(x == 0, torch.full_like(step, 2.0 ** -133), step)


def check_gemm_case(pair, m: int, n: int, k: int, splits, gen) -> float:
    """One product of the body on the card against ``gemm_body_ref`` on the
    same operands (the rules above); raises on a disagreement. Returns the
    largest error as a share of its limit."""
    from mae_clip_torch.ops import block_kernel as BK

    torch.backends.cuda.matmul.allow_tf32 = False
    a_km, b_kn, mode = pair[0] == "km", pair[1] == "kn", pair[2]
    if splits is None:
        splits = BK.gemm_dw_splits(m, n, k) if mode == "partial" else 1
    x = _gemm_inputs(gen, pair, m, n, k)
    args = (x["a"], x["b"], mode, a_km, b_kn, x["bias"], x["res"], x["aux"],
            x["outf"], "tanh", splits)
    got = BK.gemm_body(*args)
    want = BK.gemm_body_ref(*args)
    torch.cuda.synchronize()
    label = f"gemm body {pair}: M {m} N {n} K {k}, {splits} split(s)"
    am = x["a"].float().t() if a_km else x["a"].float()   # (M, K)
    bm = x["b"].float() if b_kn else x["b"].float().t()   # (K, N)
    order = 1.2 * GEMM_SUM_ORDER * (am.abs() @ bm.abs())
    acc = None
    if mode in ("bias_res", "bias_gelu"):
        acc = (am @ bm + x["bias"].float()).to(torch.bfloat16)
    worst = 0.0
    for name, w in want.items():
        g = got[name].float()
        w = w.float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{label} {name}: non-finite output")
        err = (g - w).abs()
        if name == "outf":
            limit = torch.full_like(w, GEMM_FP32_TOL * max(1.0, float(
                w.abs().max())))
        else:
            limit = _bf16_step(torch.maximum(g.abs(), w.abs())) + order
            if mode == "bias_res":
                limit = limit + _bf16_step(acc)
            elif mode == "bias_gelu" and name == "out2":
                limit = limit + 1.2 * _bf16_step(acc)
        bad = err > limit
        if bool(bad.any()):
            i = int(torch.argmax((err / limit).flatten()))
            raise AssertionError(
                f"{label} {name}: {int(bad.sum())} of {bad.numel()} outside "
                f"their limit; worst {float(err.flatten()[i]):.3e} against "
                f"{float(limit.flatten()[i]):.3e} (got "
                f"{float(g.flatten()[i]):.6g}, reference "
                f"{float(w.flatten()[i]):.6g})")
        worst = max(worst, float((err / limit).max()))
    return worst


def check_gemm_bodies(worst: dict) -> None:
    """Every template of the GEMM body (each (layout, epilogue) pair the
    stacks launch) against its plain version, at the cuts of the main
    products and the ragged shape."""
    from mae_clip_torch.ops import block_kernel as BK

    gen = torch.Generator().manual_seed(14)
    worst["gemm_body"] = 0.0
    for pair in BK.GEMM_PAIRS:
        shapes = gemm_check_shapes(pair)
        ratio = max(check_gemm_case(pair, *shape, gen) for shape in shapes)
        worst["gemm_body"] = max(worst["gemm_body"], ratio)
        log(f"  gemm body ({','.join(pair)}): {[s[:3] for s in shapes]}: "
            f"largest error {ratio:.3f} of its limit")


def check_augment_on_card() -> float:
    """The in-step crop + resample + flip and the eval resize on the card
    against the CPU, given the same boxes and flips (drawn on the CPU), at
    the pretrain step's geometry: uint8 sources of 256 px to 224 px. Within
    1e-3 on the 0..255 scale."""
    from mae_clip_torch.ops import augment

    gen = torch.Generator().manual_seed(7)
    src = torch.randint(0, 256, (16, 256, 256, 3), generator=gen,
                        dtype=torch.uint8)
    boxes = augment.sample_crop_boxes(gen, 16, 256)
    flip = torch.rand(16, generator=gen) < 0.5
    worst = 0.0
    for what, card, cpu in (
            ("crop + flip",
             augment.crop_resize_flip(src.to(DEVICE),
                                      tuple(x.to(DEVICE) for x in boxes),
                                      flip.to(DEVICE), 224),
             augment.crop_resize_flip(src, boxes, flip, 224)),
            ("resize", augment.resize_batch(src.to(DEVICE), 224),
             augment.resize_batch(src, 224))):
        err = _close(f"augment {what}", card.cpu(), cpu, 1e-3)
        log(f"  augment {what} (16, 256, 256, 3) -> 224: card vs CPU max abs "
            f"err {err:.3e}")
        worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# Phase 5: kernel times
# ---------------------------------------------------------------------------

def _call_ms(fn, iters: int = 50) -> float:
    """Wall time per call between CUDA events, host dispatch included: at
    small shapes the card waits for the host between launches."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


SPIN_CYCLES_PER_S = 2e9  # above the H100's 1980 MHz peak SM clock


def _device_ms(fn, iters: int = 20) -> float:
    """Device time per call, host dispatch excluded: ``iters`` calls are
    queued behind a spin kernel (``torch.cuda._sleep``), so the card runs
    them back to back, and timed between CUDA events recorded around them.
    The short gaps between queued kernels count; a profiler trace, which
    sums kernel durations, would leave them out. If the spin ended before
    the host had queued every call (the start event has completed), the
    card may have waited for the host: time again with a longer spin and
    fewer calls (the launch queue holds about a thousand kernels)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    spin_s = 2 * (time.perf_counter() - t0) + 1e-3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(4):
        torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_ahead = not start.query()
        torch.cuda.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / iters
        log(f"  {iters} calls not queued within a {spin_s * 1e3:.1f} ms "
            "spin; timing again")
        spin_s, iters = 4 * spin_s, max(2, iters // 2)
    raise AssertionError("the calls could not be queued ahead of the card")


def _bound_ms(bytes_moved: float, flops: float, dtype) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_serving_kernels() -> dict:
    """Kernel, plain-version and library times at the serving shapes."""
    import torch.nn.functional as F

    from mae_clip_torch.ops import attention as A

    dev, dt = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(1)
    out = {}

    # Packed: ViT-S/16 block over a 64-image gallery batch.
    b, s, h, d = 64, 197, 3, 128
    qkv = torch.randn(b, s, 3 * h * d, generator=gen).to(dev, dt)
    q, k, v = A._unpack(qkv, h)
    elt = qkv.element_size()
    bound, by = _bound_ms(qkv.numel() * elt + b * s * h * d * elt,
                          4 * b * h * s * s * d, dt)
    out["qkv_packed_attention"] = _timed(
        f"qkv ({b},{s},{3 * h * d}) bf16, {h} heads, no mask",
        lambda: A.qkv_packed_attention(qkv, None, h),
        lambda: A.qkv_packed_attention_ref(qkv, None, h),
        lambda: F.scaled_dot_product_attention(q, k, v), bound, by)

    # Flash: DistilBERT over one micro-batch of 16 queries at length 64.
    b, h, s, d = 16, 6, 64, 128
    q, k, v = (torch.randn(b, s, h, d, generator=gen).to(dev, dt)
               .transpose(1, 2) for _ in range(3))
    kv = _padding_mask(gen, b, s, dev)
    attn_mask = (kv > 0)[:, None, None, :]
    bound, by = _bound_ms(4 * b * h * s * d * elt + kv.numel() * 4,
                          4 * b * h * s * s * d, dt)
    out["flash_attention"] = _timed(
        f"q/k/v ({b},{h},{s},{d}) bf16, padding mask",
        lambda: A.flash_attention(q, k, v, kv),
        lambda: A.flash_attention_ref(q, k, v, kv),
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask),
        bound, by)
    # The same as a training step of the text tower would run it, writing
    # the row log-sum-exp (not on the serving path).
    mask = A._mask_arg(kv, b, s, q.device)
    out["flash_attention_lse"] = _timed(
        f"q/k/v ({b},{h},{s},{d}) bf16, padding mask, writing lse",
        lambda: A._launch_flash(q, k, v, mask, d ** -0.5, with_lse=True),
        lambda: A.flash_attention_lse_ref(q, k, v, kv),
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask),
        *_bound_ms(4 * b * h * s * d * elt + kv.numel() * 4 + b * h * s * 4,
                   4 * b * h * s * s * d, dt))
    _log_times(out)
    return out


def _timed(shape: str, kernel, plain, library, bound: float, by: str,
           repeats: int = 1) -> dict:
    """``library`` is one call, or a (forward+backward, forward) pair whose
    difference is the backward's time. With ``repeats`` > 1 the kernel is
    timed that many times, each over 20 calls, interleaved with the
    library's timing; ``ms`` is the median and ``ms_runs`` all of them."""
    runs, lib_runs = [], []
    for _ in range(repeats):
        runs.append(_device_ms(kernel))
        if isinstance(library, tuple):
            fwd_bwd, fwd = library
            lib_runs.append(_device_ms(fwd_bwd) - _device_ms(fwd))
        else:
            lib_runs.append(_device_ms(library))
    if isinstance(library, tuple):
        library_call_ms = _call_ms(library[0]) - _call_ms(library[1])
    else:
        library_call_ms = _call_ms(library)
    return dict(shape=shape, ms=float(np.median(runs)), ms_runs=runs,
                plain_ms=_device_ms(plain),
                library_ms=float(np.median(lib_runs)), library_ms_runs=lib_runs,
                call_ms=_call_ms(kernel), library_call_ms=library_call_ms,
                bound_ms=bound, bound_by=by)


def _log_times(times: dict) -> None:
    for name, r in times.items():
        spread = ""
        if len(r["ms_runs"]) > 1:
            spread = (f" (median of {len(r['ms_runs'])}: kernel "
                      f"{[round(x, 4) for x in r['ms_runs']]}, library "
                      f"{[round(x, 4) for x in r['library_ms_runs']]})")
        design = ""
        if "design_bound_ms" in r:
            design = (f", bound of the bytes this design moves "
                      f"{r['design_bound_ms']:.4f}")
        log(f"  {name} [{r['shape']}]: device ms per call: kernel "
            f"{r['ms']:.4f}, bound {r['bound_ms']:.4f} ({r['bound_by']})"
            f"{design}, "
            f"plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}"
            f"{spread}; wall ms per call with host dispatch: kernel "
            f"{r['call_ms']:.4f}, library {r['library_call_ms']:.4f}")


def _sdpa_fwd_bwd(q, k, v, g):
    """SDPA forward + backward through autograd, and its forward alone, on
    leaf copies of q, k, v (the yardstick of a backward kernel)."""
    import torch.nn.functional as F

    q, k, v = (t.detach().contiguous().requires_grad_() for t in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(q, k, v)

    return (lambda: torch.autograd.grad(fwd(), (q, k, v), g), fwd)


def _time_packed(qkv, g, h: int, repeats: int, d: int = 128) -> dict:
    """#1 and #3 on qkv (B, S, 3*H*Dh) and d_out g, bf16, no mask, as the
    training path runs them: #1 writes the row log-sum-exp, #3 reads it and
    the forward's output. #1's bound counts the log-sum-exp, an output the
    backward needs. #3's bound counts only what d_qkv needs (qkv and d_out
    read, d_qkv written): its reads of the output and the log-sum-exp are
    this design's choice, so they go into ``design_bound_ms`` beside it.
    #3's operations are its five products (S, dP, dV, dK, dQ)."""
    import torch.nn.functional as F

    from mae_clip_torch.ops import attention as A

    b, s, _ = qkv.shape
    scale = d ** -0.5
    q, k, v = A._unpack(qkv, h)
    g4 = g.view(b, s, h, d).transpose(1, 2)
    elt = qkv.element_size()
    lse_bytes = b * h * s * 4
    out, lse = A._launch_packed(qkv, None, h, scale, with_lse=True)
    flops = 2 * b * h * s * s * d  # one (S x S x Dh) product
    shape = f"qkv ({b},{s},{3 * h * d}) bf16, {h} heads, no mask"
    bwd_bytes = (2 * qkv.numel() + g.numel()) * elt
    design = bwd_bytes + out.numel() * elt + lse_bytes
    times = {
        "qkv_packed_attention": _timed(
            shape + ", writing lse",
            lambda: A._launch_packed(qkv, None, h, scale, with_lse=True),
            lambda: A.qkv_packed_attention_lse_ref(qkv, None, h),
            lambda: F.scaled_dot_product_attention(q, k, v),
            *_bound_ms((qkv.numel() + out.numel()) * elt + lse_bytes,
                       2 * flops, torch.bfloat16), repeats=repeats),
        "qkv_packed_attention_bwd": _timed(
            shape + f", d_out ({b},{s},{h * d}), reading out and lse",
            lambda: A._launch_packed_bwd(qkv, None, h, scale, out, lse, g),
            lambda: A.qkv_packed_attention_bwd_lse_ref(qkv, None, h, scale,
                                                       out, lse, g),
            _sdpa_fwd_bwd(q, k, v, g4),
            *_bound_ms(bwd_bytes, 5 * flops, torch.bfloat16),
            repeats=repeats)}
    times["qkv_packed_attention_bwd"]["design_bound_ms"] = _bound_ms(
        design, 5 * flops, torch.bfloat16)[0]
    return times


def time_training_kernels() -> dict:
    """All four kernels at the flagship training step's shapes (bf16, no
    mask): the encoder's packed qkv (256, 50, 1152) and the decoder's
    cross-attention, q (256, 2, 147, 128) and k/v (256, 2, 50, 128). Each
    kernel is timed 7 times (median and spread), with the SM clock read
    before and after."""
    dev, dt = DEVICE, torch.bfloat16
    gen = torch.Generator().manual_seed(4)
    out = {}
    log(f"  SM clock, max SM clock before: {clock_line()}")

    b, s, h, d = 256, 50, 3, 128
    qkv = torch.randn(b, s, 3 * h * d, generator=gen).to(dev, dt)
    g = torch.randn(b, s, h * d, generator=gen).to(dev, dt)
    out.update(_time_packed(qkv, g, h, repeats=7))

    b, h, sq, sk = 256, 2, 147, 50
    q = torch.randn(b, sq, h, d, generator=gen).to(dev, dt).transpose(1, 2)
    kv = torch.randn(b, sk, 2, h, d, generator=gen).to(dev, dt)
    k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    g = torch.randn(b, sq, h, d, generator=gen).to(dev, dt).transpose(1, 2)
    out.update(_time_flash(q, k, v, g, "strided head views, no mask", 7))
    log(f"  SM clock, max SM clock after: {clock_line()}")
    _log_times(out)
    return out


def _time_flash(q, k, v, g, what: str, repeats: int) -> dict:
    """#2 and #4 on q (B, H, Sq, Dh), k/v (B, H, Sk, Dh) and d_out g, bf16,
    no mask, as the training path runs them: #2 writes the row
    log-sum-exp (``ms``; without it: the ``flash_attention_no_lse`` entry,
    as serving runs it), #4 reads it and #2's output. #2's bound counts the
    lse, an output the backward needs. #4's bound counts only what dq, dk
    and dv need (q, k, v and d_out read, dq, dk, dv written); its reads of
    the output and lse are this design's choice (``design_bound_ms``). #4's
    operations are its five products."""
    import torch.nn.functional as F

    from mae_clip_torch.ops import attention as A

    b, h, sq, d = q.shape
    sk, dt, elt = k.shape[2], q.dtype, q.element_size()
    scale = d ** -0.5
    lse_bytes = b * h * sq * 4
    o, lse = A._launch_flash(q, k, v, None, scale, with_lse=True)
    flops = 2 * b * h * sq * sk * d
    moved = (q.numel() + k.numel() + v.numel()) * elt
    shape = f"q ({b},{h},{sq},{d}) k/v ({b},{h},{sk},{d}) bf16, {what}"
    times = {
        "flash_attention": _timed(
            shape + ", writing lse",
            lambda: A._launch_flash(q, k, v, None, scale, with_lse=True),
            lambda: A.flash_attention_lse_ref(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v),
            *_bound_ms(moved + q.numel() * elt + lse_bytes, 2 * flops, dt),
            repeats=repeats),
        "flash_attention_no_lse": _timed(
            shape, lambda: A.flash_attention(q, k, v),
            lambda: A.flash_attention_ref(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v),
            *_bound_ms(moved + q.numel() * elt, 2 * flops, dt),
            repeats=repeats),
        "flash_attention_bwd": _timed(
            shape + ", reading out and lse",
            lambda: A._launch_flash_bwd(q, k, v, None, scale, o, lse, g),
            lambda: A.flash_attention_bwd_lse_ref(q, k, v, None, scale, o,
                                                  lse, g),
            _sdpa_fwd_bwd(q, k, v, g),
            *_bound_ms(2 * moved + q.numel() * elt, 5 * flops, dt),
            repeats=repeats)}
    times["flash_attention_bwd"]["design_bound_ms"] = _bound_ms(
        2 * moved + 2 * q.numel() * elt + lse_bytes, 5 * flops, dt)[0]
    return times


def time_wide_heads() -> dict:
    """The attention kernels at heads of 256 (their scalar bodies), bf16,
    no mask: #2/#4 at DistilBERT's serving micro-batch with 3 heads of 256,
    q/k/v (16, 3, 64, 256), and #1/#3 at the same rows packed, qkv
    (16, 64, 2304). 3 timings each (median)."""
    gen = torch.Generator().manual_seed(12)
    dt = torch.bfloat16
    b, h, s, d = 16, 3, 64, 256
    q, k, v, g = (torch.randn(b, s, h, d, generator=gen).to(DEVICE, dt)
                  .transpose(1, 2) for _ in range(4))
    out = _time_flash(q, k, v, g, "strided head views, no mask", 3)
    qkv = torch.randn(b, s, 3 * h * d, generator=gen).to(DEVICE, dt)
    g = torch.randn(b, s, h * d, generator=gen).to(DEVICE, dt)
    out.update(_time_packed(qkv, g, h, repeats=3, d=d))
    _log_times(out)
    return out


def time_large_batch_kernels() -> dict:
    """#1 and #3 at ``large_batch_mesh_config``'s encoder (phase 14): one
    microbatch of 4,096 at S=50 with the canonical 6 heads of 64, qkv
    (4096, 50, 1152), bf16, no mask, as ``_time_packed`` runs them. 3
    timings each (median)."""
    gen = torch.Generator().manual_seed(15)
    dt = torch.bfloat16
    b, s, h, d = 4096, 50, 6, 64
    qkv = torch.randn(b, s, 3 * h * d, generator=gen).to(DEVICE, dt)
    g = torch.randn(b, s, h * d, generator=gen).to(DEVICE, dt)
    out = _time_packed(qkv, g, h, repeats=3, d=d)
    _log_times(out)
    return out


def time_pretrain_kernels() -> dict:
    """The MAE-pretrain step's kernels at its shapes (bf16): the masked
    patch embedding (256, 196, 768) -> (256, 49, 384), and the MAE-paper
    decoder's packed qkv (256, 197, 768), 2 heads of 128, forward (writing
    the log-sum-exp) and backward (reading it). Each kernel is timed 7
    times (median and spread)."""
    import torch.nn.functional as F

    from mae_clip_torch.ops import patch_embed as PE

    dt = torch.bfloat16
    gen = torch.Generator().manual_seed(8)
    out = {}
    log(f"  SM clock, max SM clock before: {clock_line()}")

    b, n, d_in, k, d_m = PATCH_EMBED_SHAPE
    p, ids, w, bias = _patch_embed_inputs(gen, PATCH_EMBED_SHAPE, dt)
    elt = p.element_size()
    moved = ((b * k * d_in + d_m * d_in + d_m + b * k * d_m) * elt
             + ids.numel() * ids.element_size())
    # The yardstick is two PyTorch calls: the gather, then F.linear.
    t = out["masked_patch_embed"] = _timed(
        f"patches ({b},{n},{d_in}) bf16, ids ({b},{k}), W ({d_m},{d_in}); "
        f"library = take_along_dim + F.linear (two calls)",
        lambda: PE.masked_patch_embed(p, ids, w, bias),
        lambda: PE.masked_patch_embed_ref(p, ids, w, bias),
        lambda: F.linear(torch.take_along_dim(p, ids[:, :, None], 1), w,
                         bias),
        *_bound_ms(moved, 2 * b * k * d_in * d_m, dt), repeats=7)
    t["bound_share"] = t["bound_ms"] / t["ms"]
    # PatchEmbed casts all N rows of each image to the compute type before
    # the kernel reads K of them (models/vit.py): the cast alone (read fp32,
    # write bf16, once each), and the cast followed by the kernel.
    p32 = p.float()
    t["cast_ms"] = _device_ms(lambda: p32.to(dt))
    t["cast_bound_ms"] = p32.numel() * (4 + 2) / HBM_BYTES_PER_S * 1e3
    t["cast_and_kernel_ms"] = _device_ms(
        lambda: PE.masked_patch_embed(p32.to(dt), ids, w, bias))
    log(f"  masked_patch_embed: {100 * t['bound_share']:.1f} % of its bound; "
        f"the cast of the fp32 patches in front of it "
        f"{t['cast_ms']:.4f} ms (bound {t['cast_bound_ms']:.4f}), cast + "
        f"kernel {t['cast_and_kernel_ms']:.4f} ms")

    b, s, h, d = 256, 197, 2, 128
    qkv = torch.randn(b, s, 3 * h * d, generator=gen).to(DEVICE, dt)
    g = torch.randn(b, s, h * d, generator=gen).to(DEVICE, dt)
    out.update(_time_packed(qkv, g, h, repeats=7))
    log(f"  SM clock, max SM clock after: {clock_line()}")
    _log_times(out)
    return out


def _queued_ms(fn, iters: int = 10) -> tuple:
    """(device ms, host ms) per call of a function that launches more
    kernels than the launch queue holds (a block stack is hundreds), so
    ``_device_ms``'s spin cannot queue its calls ahead: CUDA events around
    ``iters`` calls back to back. While the host queues a call in less time
    than the card runs one, the card never waits, and the event time is its
    time; the host's time to queue one call on an idle card is returned
    beside it."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_ms


# The fused block stacks at the flagship training step's shapes
# (B, Sq, Sk, D, H, F, L, cross): the ViT-S/16 encoder and the CrossMAE
# decoder.
STACK_SHAPES = {"encoder": (256, 50, 50, 384, 3, 1536, 12, False),
                "decoder": (256, 147, 50, 256, 2, 1024, 4, True)}


def _stack_work(shape, elt: int) -> tuple:
    """(bytes, FLOPs) the forward stack must move and do, the same for the
    backward, and the bytes of the state #6 keeps for #7: each input read
    once and each output written once; the products over the real rows (no
    padding). The backward does twice the forward's products (input and
    weight gradients); it reads the forward's state and recomputes nothing.
    The state (activations in the compute type, row statistics in fp32) is
    the design's, not the function's: it goes into ``design_bound_ms``."""
    b, sq, sk, d, h, f, n, cross = shape
    m, mk = b * sq, b * (sk if cross else sq)
    gemm = 2 * m * d * d * 2 + 2 * mk * 2 * d * d + 4 * m * d * f
    attn = 4 * m * mk // b * d     # q k^T and P v over all heads
    weights = n * (4 * d * d + 2 * d * f + 11 * d + f) * elt
    acts = m * d * elt
    kv_bytes = mk * d * elt if cross else 0
    fwd_bytes = acts + kv_bytes + weights + acts + n * acts
    bwd_bytes = n * acts + kv_bytes + weights + acts + acts + kv_bytes \
        + weights
    state_bytes = n * ((5 * m * d + (mk * d if cross else 0) + 2 * mk * d
                        + 2 * m * f) * elt
                       + (b * h * sq + 4 * m + (2 * mk if cross else 0)) * 4)
    return (fwd_bytes, n * (gemm + attn), bwd_bytes, 2 * n * (gemm + attn),
            state_bytes)


# block_common.cuh's EpiMode, in order: the GEMM bodies' epilogues.
EPILOGUES = ("bias", "bias+residual", "bias+gelu", "gelu grad", "fp32",
             "fp32 add", "round", "split partials")


def _kernel_group(name: str) -> str:
    """The group of a block stack's kernel in a launch breakdown: the GEMM
    bodies by template (operand layouts, epilogue), the weight-gradient
    reduce, the column sums, LayerNorm forward and backward, attention
    forward and backward; the body with a gathered A (kernel #5) as
    layout "gather"."""
    m = re.search(r"gemm_wgmma_kernel<(\w+),\s*(\w+),\s*(\d+)"
                  r"(?:,\s*(\w+))?>", name)
    if m:
        km, kn = m[1] in ("true", "1"), m[2] in ("true", "1")
        a = "gather" if m[4] in ("true", "1") else "km" if km else "mk"
        return (f"GEMM wgmma<{a},{'kn' if kn else 'nk'},"
                f"{EPILOGUES[int(m[3])]}>")
    m = re.search(r"reduce_rows_kernel<[^<>]*?(\d+)>", name)
    if m:
        return "weight-gradient reduce" if m[1] == "0" else "column sums"
    for key, group in (("gemm_scalar_kernel", "GEMM scalar"),
                       ("colsum_kernel", "column sums"),
                       ("ln_bwd_kernel", "LayerNorm backward"),
                       ("ln_fwd_kernel", "LayerNorm forward"),
                       ("attn_bwd", "attention backward"),
                       ("attn_fwd", "attention forward"),
                       ("Memcpy", "copy"), ("Memset", "memset"),
                       ("at::native", "PyTorch (the wrapper's own)")):
        if key in name:
            return group
    if "gemm" in name.lower():  # a GEMM body this map does not know
        return "GEMM unknown body"
    return name[:60]


# Groups that are forward work: none may appear in #7's breakdown.
FORWARD_GROUPS = ("LayerNorm forward", "attention forward",
                  "GEMM wgmma<mk,nk")
# Groups of bf16 products that did not run the wgmma body.
OFF_BODY_GROUPS = ("GEMM scalar", "GEMM unknown body")


def _launch_breakdown(fn, traces: int = 3) -> dict:
    """Device ms and launches of one call of a block stack, by kernel group
    (``_kernel_group``), largest first, from a torch.profiler trace: of
    ``traces`` traces of one call each, the one with the most launches.
    Kernels launched in the first milliseconds of a trace have gone
    unrecorded (the first block's, or more), so each trace waits 0.2 s
    before the call; the launches of each trace are logged."""
    def traced():
        time.sleep(0.2)
        fn()

    windows = [profile_window(traced, top=0, names=True)
               for _ in range(traces)]
    log(f"  launches in {traces} traces of one call: "
        f"{[w['kernel_launches'] for w in windows]}")
    window = max(windows, key=lambda w: w["kernel_launches"])
    groups = {}
    for name, (ms, n) in window["kernels_by_name"].items():
        ms0, n0 = groups.get(_kernel_group(name), (0.0, 0))
        groups[_kernel_group(name)] = (ms0 + ms, n0 + n)
    return {g: dict(ms=round(ms, 4), launches=n) for g, (ms, n) in
            sorted(groups.items(), key=lambda kv: -kv[1][0])}


def _busy_ms(fn, calls: int = 3) -> float:
    """Device ms per call of ``fn``: its kernels' device times summed over
    a torch.profiler trace of ``calls`` calls (``profile_window``)."""
    window = profile_window(lambda: [fn() for _ in range(calls)], top=1)
    return window["device_busy_ms"] / calls


def time_block_stacks() -> dict:
    """#6 and #7 at the encoder's and the decoder's shapes (bf16), 7 timings
    each (median and spread), beside their bound, their plain versions and
    the port's own ``fused_blocks='off'`` per-block path on the same weights
    (no single PyTorch call computes a block stack): its forward, and its
    forward + backward less its forward. #6 is timed without a state (its
    ``ms``, as serving runs it) and with one (``with_state``, as training
    does); #7 from that state. The 'off' path's time is its device time
    from a trace (3 timings, median): back to back, its wall time is the
    host's queueing of ~30 launches per block (``library_wall_ms``, kept
    beside it). Then one call of #6 (with a state) and one of #7, each
    broken down by kernel group from a trace; #7's must hold no forward
    work."""
    from mae_clip_torch.models.mae import (CrossAttnBlock,
                                           collect_cross_block_weights)
    from mae_clip_torch.models.vit import (ViTBlock, ViTConfig,
                                           collect_self_block_weights)
    from mae_clip_torch.models.layers import init_weights
    from mae_clip_torch.ops import block_kernel as BK

    dt = torch.bfloat16
    gen = torch.Generator().manual_seed(11)
    out = {}
    log(f"  SM clock, max SM clock before: {clock_line()}")
    for which, shape in STACK_SHAPES.items():
        b, sq, sk, d, h, f, n, cross = shape
        vcfg = ViTConfig(dim=d, depth=n, n_heads=h, mlp_ratio=f / d,
                         gelu="tanh")
        block = CrossAttnBlock if cross else ViTBlock
        blocks = torch.nn.ModuleList(block(vcfg, dt) for _ in range(n))
        blocks = init_weights(blocks, gen).to(DEVICE)
        w = (collect_cross_block_weights(blocks, dt) if cross else
             collect_self_block_weights(blocks, d, dt))
        w = {k: v.detach() for k, v in w.items()}
        q0 = torch.randn(b, sq, d, generator=gen).to(DEVICE, dt)
        kv = torch.randn(b, sk, d, generator=gen).to(DEVICE, dt) \
            if cross else q0
        dout = torch.randn(b, sq, d, generator=gen).to(DEVICE, dt)
        _, qstack, state = BK._launch_fwd(q0, kv, w, h, "tanh", cross,
                                          keep_state=True)
        views = BK.state_views(state, qstack, kv, w, h, cross)
        params = list(blocks.parameters())
        x_leaf = q0.clone().requires_grad_()
        kv_leaf = kv.clone().requires_grad_() if cross else None

        def per_block(x, y):
            for blk in blocks:
                x = blk(x, y) if cross else blk(x)
            return x

        def off_fwd():
            with torch.no_grad():
                return per_block(q0, kv)

        def off_fwd_graph():
            return per_block(x_leaf, kv_leaf)

        def off_fwd_bwd():
            leaves = [x_leaf] + ([kv_leaf] if cross else []) + params
            return torch.autograd.grad(off_fwd_graph(), leaves, dout)

        fb, ff, bb, bf, sb = _stack_work(shape, 2)
        off_runs = {"fwd": [], "bwd": []}
        for _ in range(3):
            off_runs["fwd"].append(_busy_ms(off_fwd))
            off_runs["bwd"].append(_busy_ms(off_fwd_bwd)
                                   - _busy_ms(off_fwd_graph))
        off_wall = {"fwd": _queued_ms(off_fwd)[0],
                    "bwd": _queued_ms(off_fwd_bwd)[0]
                    - _queued_ms(off_fwd_graph)[0]}
        label = (f"{which}: q ({b},{sq},{d})" + (f" kv ({b},{sk},{d})"
                                                  if cross else "")
                 + f", {n} blocks, {h} heads of {d // h}, F={f}, bf16")
        def fwd_state():
            return BK._launch_fwd(q0, kv, w, h, "tanh", cross,
                                  keep_state=True)

        def bwd():
            return BK._launch_bwd(qstack, kv, w, dout, state, h, "tanh",
                                  cross)

        cases = {
            "fused_block_stack": (
                lambda: BK._launch_fwd(q0, kv, w, h, "tanh", cross),
                lambda: BK.fused_block_stack_ref(q0, kv, w, h, "tanh",
                                                 cross),
                "fwd", _bound_ms(fb, ff, dt)),
            "fused_block_stack_bwd": (
                bwd,
                lambda: BK.fused_block_stack_bwd_ref(qstack, kv, w, dout, h,
                                                     "tanh", cross,
                                                     state=views),
                "bwd", _bound_ms(bb, bf, dt))}
        design = {"fused_block_stack": _bound_ms(fb + sb, ff, dt)[0],
                  "fused_block_stack_bwd": _bound_ms(bb + sb, bf, dt)[0]}
        for name, (kernel, plain, part, (bound, by)) in cases.items():
            runs, host = [], []
            for _ in range(7):
                ms, hms = _queued_ms(kernel)
                runs.append(ms)
                host.append(hms)
            lib_runs = off_runs[part]
            r = dict(shape=label, ms=float(np.median(runs)), ms_runs=runs,
                     host_ms=float(np.median(host)),
                     plain_ms=_queued_ms(plain, iters=3)[0],
                     library_ms=float(np.median(lib_runs)),
                     library_ms_runs=lib_runs,
                     library_wall_ms=off_wall[part], bound_ms=bound,
                     bound_by=by, design_bound_ms=design[name],
                     state_gb=sb / 1e9,
                     library="device time of the port's fused_blocks='off' "
                             "per-block path on the same weights" + (
                                 " (forward + backward less forward)"
                                 if part == "bwd" else " (forward)"))
            out.setdefault(name, {})[which] = r
            log(f"  {name} [{label}]: device ms per call: kernel "
                f"{r['ms']:.4f} (7 timings {[round(x, 4) for x in runs]}; "
                f"host queues a call in {r['host_ms']:.3f} ms), bound "
                f"{bound:.4f} ({by}), plain {r['plain_ms']:.4f}, "
                f"'off' path device {r['library_ms']:.4f} "
                f"{[round(x, 4) for x in lib_runs]}, wall back to back "
                f"{r['library_wall_ms']:.4f}; design bound with the state "
                f"({sb / 1e9:.3f} GB {'read' if part == 'bwd' else 'written'}"
                f") {design[name]:.4f}")
        runs = [_queued_ms(fwd_state)[0] for _ in range(7)]
        r = out["fused_block_stack"][which]
        r["with_state"] = dict(ms=float(np.median(runs)), ms_runs=runs,
                               design_bound_ms=design["fused_block_stack"])
        log(f"  fused_block_stack with its state [{label}]: device ms per "
            f"call {r['with_state']['ms']:.4f} (7 timings "
            f"{[round(x, 4) for x in runs]}; without {r['ms']:.4f})")
        for name, fn in (("fused_block_stack", fwd_state),
                         ("fused_block_stack_bwd", bwd)):
            parts = _launch_breakdown(fn)
            out[name][which]["launch_breakdown"] = parts
            log(f"  {name} [{which}] one call by kernel group (device ms, "
                f"launches): {json.dumps(parts)}; sum "
                f"{sum(v['ms'] for v in parts.values()):.4f} ms")
        fwd_work = [g for g in out["fused_block_stack_bwd"][which][
            "launch_breakdown"] if g.startswith(FORWARD_GROUPS)]
        if fwd_work:
            raise AssertionError(f"#7 launched forward work: {fwd_work}")
        for name, per_block in (("fused_block_stack", 5),
                                ("fused_block_stack_bwd", 10)):
            parts = out[name][which]["launch_breakdown"]
            off = [g for g in parts if g.startswith(OFF_BODY_GROUPS)]
            if off:
                raise AssertionError(f"{name} [{which}]: bf16 products off "
                                     f"the wgmma body: {off}")
            body = sum(v["launches"] for g, v in parts.items()
                       if g.startswith("GEMM wgmma"))
            log(f"  {name} [{which}]: {body} launches of the wgmma body in "
                f"the trace, of {per_block * n} products a call")
        del state, views
    log(f"  SM clock, max SM clock after: {clock_line()}")
    return out


def time_gemm_shapes() -> dict:
    """Each bf16 product of #6 and #7 at both stack shapes (``stack_gemms``),
    alone: the GEMM body (``BK._launch_gemm``) against one PyTorch call on the same operands
    (F.linear with the bias for a forward product, torch.matmul for an
    input gradient, and for a weight gradient over all rows at once), a
    yardstick the port never calls; beside the bound (the operands read
    once, what the epilogue reads and writes once, or 2 M N K over the bf16
    rate). The weight gradients run #7's row splits. ``_device_ms`` each."""
    import torch.nn.functional as F

    from mae_clip_torch.ops import block_kernel as BK

    gen = torch.Generator().manual_seed(13)
    out = {}
    for which, shape in STACK_SHAPES.items():
        rows = []
        for g in stack_gemms(shape):
            pair, m, n, k = g["pair"], g["m"], g["n"], g["k"]
            a_km, b_kn, mode = pair[0] == "km", pair[1] == "kn", pair[2]
            splits = BK.gemm_dw_splits(m, n, k) if mode == "partial" else 1
            x = _gemm_inputs(gen, pair, m, n, k)
            a, b = x["a"], x["b"]
            outs = {name: torch.empty(
                (splits, m, n) if mode == "partial" else (m, n),
                dtype=torch.float32 if name == "outf" else a.dtype,
                device=DEVICE) for name in BK.GEMM_OUTPUTS[mode]}
            if mode == "f32_add":
                outs["outf"] = x["outf"]

            def body():
                BK._launch_gemm(a, b, mode, a_km, b_kn, x["bias"], x["res"],
                                x["aux"], outs.get("out"), outs.get("out2"),
                                outs.get("outf"), "tanh", splits)

            if pair[1] == "nk":
                def library():
                    return F.linear(a, b, x["bias"])
            elif a_km:
                def library():
                    return torch.matmul(a.t(), b)
            else:
                def library():
                    return torch.matmul(a, b)
            moved = sum(t.numel() * t.element_size() for t in
                        [a, b] + list(outs.values())
                        + [x[key] for key in ("bias", "res", "aux", "outf")
                           if x[key] is not None])
            bound, by = _bound_ms(moved, 2 * m * n * k, torch.bfloat16)
            r = dict(g, pair=",".join(pair), splits=splits,
                     ms=_device_ms(body), library_ms=_device_ms(library),
                     bound_ms=bound, bound_by=by)
            r["tflops"] = 2 * m * n * k / r["ms"] / 1e9
            rows.append(r)
            log(f"  gemm [{which}] {g['name']} ({r['pair']}) M {m} N {n} K "
                f"{k}{f', {splits} splits' if splits > 1 else ''}: device ms "
                f"body {r['ms']:.4f} ({r['tflops']:.0f} TFLOP/s), library "
                f"{r['library_ms']:.4f}, bound {bound:.4f} ({by}); "
                f"{g['per_call']} a call")
        total = sum(r["ms"] * r["per_call"] for r in rows)
        log(f"  gemm [{which}]: the body's products of one call of #6 "
            f"{sum(r['ms'] * r['per_call'] for r in rows if r['kernel'] == 'fused_block_stack'):.4f} "
            f"ms and of #7 "
            f"{sum(r['ms'] * r['per_call'] for r in rows if r['kernel'] == 'fused_block_stack_bwd'):.4f}"
            f" ms (both {total:.4f})")
        out[which] = rows
    return out


# ---------------------------------------------------------------------------
# Phase 3: the serving path at flagship width
# ---------------------------------------------------------------------------

GALLERY_ROWS = 50_000
IMAGE_BATCH = 64
IMAGE_GALLERY = 256
MICRO_BATCH = 16
FIXED_LENGTH = 64
DEDUP_STRIDE = 5
TOP_N = 9            # top-45 with stride-5 dedup
CORPUS = ["a photo of a dog on a beach", "a red ball on the grass",
          "a cat sits on a sofa", "a diagram of a bridge",
          "noodle soup in a bowl", "two people riding bicycles"]


def build_flagship(device: str, compute_dtype: str, seed: int = 0):
    from mae_clip_torch import flagship_tpu_config
    from mae_clip_torch.models import CLIPModel, DistilBertConfig

    cfg = flagship_tpu_config(batch_size=MICRO_BATCH, max_length=FIXED_LENGTH,
                              compute_dtype=compute_dtype)
    model = CLIPModel(cfg, DistilBertConfig(), device=device)
    return model.init_weights(torch.Generator().manual_seed(seed))


def _post(base: str, path: str, payload: dict) -> dict:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        raise AssertionError(f"POST {path}: HTTP {e.code} "
                             f"{e.read().decode()}") from e


def _concurrently(fn, args_list):
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(args_list)) as pool:
        futures = [pool.submit(fn, *a) for a in args_list]
        return [f.result() for f in futures]


def _check_retrieval(r: dict, gallery_rows: int) -> None:
    scores = np.asarray(r["scores"])
    if len(r["matches"]) != TOP_N or len(r["indices"]) != TOP_N:
        raise AssertionError(f"/retrieve returned {len(r['matches'])} matches")
    if not np.isfinite(scores).all() or (np.diff(scores) > 0).any():
        raise AssertionError(f"/retrieve scores not finite/descending: {scores}")
    if not all(0 <= i < gallery_rows for i in r["indices"]):
        raise AssertionError("/retrieve index out of the gallery")


def _check_embeddings(emb, rows: int, dim: int, what: str) -> np.ndarray:
    emb = np.asarray(emb, dtype=np.float64)
    if emb.shape != (rows, dim) or not np.isfinite(emb).all():
        raise AssertionError(f"{what}: shape {emb.shape}, finite "
                             f"{np.isfinite(emb).all()}")
    return emb


def _median_ms(fn, reps: int = 7) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def stage_breakdown(service, queries) -> dict:
    """Host-clock median of each stage of one micro-batch of /retrieve
    queries, called directly (no HTTP, no batcher thread)."""
    from mae_clip_torch.data.tokenizer import pad_token_batch

    def tokenize():
        enc = service.tokenizer.encode_batch(
            queries, max_length=FIXED_LENGTH, fixed_length=FIXED_LENGTH)
        return pad_token_batch(np.asarray(enc["input_ids"], np.int64),
                               np.asarray(enc["attention_mask"], np.int64),
                               MICRO_BATCH)

    ids, mask = tokenize()
    emb = service._embed_text(ids, mask)
    items = [(q, TOP_N) for q in queries]
    return dict(
        tokenize_ms=_median_ms(tokenize),
        text_tower_ms=_median_ms(lambda: service._embed_text(ids, mask)),
        topk_ms=_median_ms(lambda: service._topk(emb, service._mb_k)),
        batched_call_ms=_median_ms(lambda: service._retrieve_many(items)))


def profile_window(fn, top: int = 6, spans=(), check=None,
                   tries: int = 3, names: bool = False) -> dict:
    """Device busy time over one call of ``fn``, from a torch.profiler
    trace: the sum of CUDA kernel times over the call's host wall time, and
    the ``top`` kernels that take most of it. For each record_function span
    named in ``spans``: its host ms (summed over its occurrences) and the
    device ms of the kernels launched under it from the calling thread.
    With ``names``, also every kernel's full name with its device ms and
    launches (``kernels_by_name``).

    The profiler now and then hands back a trace without the card's events,
    so a trace with no kernel, or one that ``check`` (which raises
    AssertionError) refuses, is taken again, up to ``tries`` calls of
    ``fn`` in all; the last refusal is raised."""
    for attempt in range(1, tries + 1):
        window = _profile_once(fn, top, spans, names)
        try:
            if not window["kernel_launches"]:
                raise AssertionError("the profiler recorded no device time")
            if check is not None:
                check(window)
            return window
        except AssertionError as e:
            if attempt == tries:
                raise
            log(f"  profiler trace {attempt} of {tries} refused ({e}); "
                "tracing again")


def _profile_once(fn, top: int, spans, names: bool = False) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # record_function spans (the step's, the optimizer's) also show on the
    # device's timeline as user annotations; they are not kernels.
    events = prof.events()

    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith(("Optimizer.", "train_step."))]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    by_name, launches = {}, {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
        launches[e.name] = launches.get(e.name, 0) + 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    span_ms = {}
    for name in spans:
        hits = [e for e in events
                if e.name == name and e.device_type == DeviceType.CPU]
        # The span's extent on the device's timeline (its first kernel's
        # start to its last kernel's end): the stream runs in order, so the
        # kernels that start inside it are the span's.
        extents = [(e.time_range.start, e.time_range.end) for e in events
                   if e.name == name and e.device_type == DeviceType.CUDA]
        inside = [k for k in kernels
                  if any(a <= k.time_range.start < b for a, b in extents)]
        span_ms[name] = dict(
            count=len(hits), device_count=len(extents),
            host_ms=sum(e.cpu_time_total for e in hits) / 1e3,
            device_ms=sum(k.device_time_total for k in inside) / 1e3,
            launches=len(inside))
    window = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                  busy_share=busy_ms / wall_ms if busy_ms else None,
                  kernel_launches=len(kernels),
                  top_kernels_ms={k[:60]: round(v, 4) for k, v in top},
                  spans=span_ms)
    if names:
        window["kernels_by_name"] = {k: (v, launches[k])
                                     for k, v in by_name.items()}
    return window


def serve_flagship(model, rng: np.random.Generator) -> dict:
    """Gallery build + HTTP serving over fp32 and int8 galleries. Returns
    end-to-end timings; raises on any wrong answer."""
    from mae_clip_torch.data.tokenizer import WordPieceTokenizer, build_vocab
    from mae_clip_torch.eval.retrieval import compute_image_embeddings
    from mae_clip_torch.ops.retrieval import l2_normalize
    from mae_clip_torch.serve import (RetrievalService, make_server,
                                      serve_forever_in_thread)

    size, proj = model.cfg.size, model.cfg.projection_dim
    tok = WordPieceTokenizer(build_vocab(CORPUS * 4, vocab_size=256))

    images = rng.integers(0, 256, (IMAGE_GALLERY, size, size, 3), np.uint8)

    def embed_gallery():
        loader = ({"image": images[s:s + IMAGE_BATCH]}
                  for s in range(0, IMAGE_GALLERY, IMAGE_BATCH))
        return compute_image_embeddings(model, loader)

    image_emb = embed_gallery()
    _check_embeddings(image_emb.cpu(), IMAGE_GALLERY, proj, "image gallery")
    timings = {"gallery_ms": _median_ms(embed_gallery, reps=3),
               "gallery_profile": profile_window(embed_gallery)}
    log(f"  image gallery: {IMAGE_GALLERY} images (batch {IMAGE_BATCH}) in "
        f"{timings['gallery_ms']:.2f} ms, warm; profiled: "
        f"{json.dumps(timings['gallery_profile'])}")

    rest = torch.randn(GALLERY_ROWS - IMAGE_GALLERY, proj,
                       generator=torch.Generator().manual_seed(2))
    gallery = torch.cat([l2_normalize(image_emb.cpu()), l2_normalize(rest)])
    names = [f"im{i}.jpg" for i in range(GALLERY_ROWS)]
    queries = [f"{c} number {i}" for i, c in
               enumerate(CORPUS * (MICRO_BATCH // len(CORPUS) + 1))]
    queries = queries[:MICRO_BATCH]
    for quantize in (False, True):
        kind = "int8" if quantize else "fp32"
        service = RetrievalService(model, tok, gallery=gallery,
                                   gallery_names=names,
                                   max_length=FIXED_LENGTH,
                                   dedup_stride=DEDUP_STRIDE,
                                   quantize_gallery=quantize)
        batcher = service.enable_micro_batching(
            max_batch=MICRO_BATCH, max_wait_ms=5.0,
            fixed_length=FIXED_LENGTH, max_n=TOP_N)
        server = make_server(service)
        serve_forever_in_thread(server)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            # Every endpoint at once, from client threads.
            requests = [("/retrieve", {"query": q, "n": TOP_N})
                        for q in queries]
            requests += [
                ("/embed_text", {"texts": CORPUS[:3]}),
                ("/embed_image", {"images": images[:2].tolist(),
                                  "raw_uint8": True}),
                ("/zeroshot", {"labels": ["dog", "cat", "soup"],
                               "image": images[0].tolist(),
                               "raw_uint8": True})]
            *rets, txt, img, zs = _concurrently(
                lambda path, body: _post(base, path, body), requests)
            for r in rets:
                _check_retrieval(r, GALLERY_ROWS)
            _check_embeddings(txt["embeddings"], 3, proj, "/embed_text")
            emb = _check_embeddings(img["embeddings"], 2, proj,
                                    "/embed_image")
            direct = image_emb[:2].cpu().numpy()
            if np.abs(emb - direct).max() > 5e-2:
                raise AssertionError("/embed_image disagrees with the gallery "
                                     "embedding of the same images")
            zs = zs["probs"]
            if set(zs) != {"dog", "cat", "soup"} or \
                    abs(sum(zs.values()) - 1.0) > 1e-3:
                raise AssertionError(f"/zeroshot probs {zs}")

            # End to end: bursts of MICRO_BATCH concurrent /retrieve calls.
            def burst():
                _concurrently(lambda q: _post(base, "/retrieve",
                                              {"query": q, "n": TOP_N}),
                              [(q,) for q in queries])

            bursts = []
            for _ in range(10):
                t0 = time.perf_counter()
                burst()
                bursts.append((time.perf_counter() - t0) * 1e3)
            timings[kind] = dict(median_ms=float(np.median(bursts)),
                                 min_ms=float(np.min(bursts)),
                                 batches=batcher.batches_run,
                                 items=batcher.items_run)
            log(f"  {kind} gallery ({GALLERY_ROWS} rows): burst of "
                f"{MICRO_BATCH} /retrieve median {timings[kind]['median_ms']:.2f}"
                f" ms, min {timings[kind]['min_ms']:.2f} ms; "
                f"{batcher.items_run} queries in {batcher.batches_run} "
                f"micro-batches")
            timings[kind]["stages"] = stage_breakdown(service, queries)
            timings[kind]["profile"] = profile_window(burst)
            log(f"  {kind} stages of one micro-batch: "
                f"{json.dumps(timings[kind]['stages'])}")
            log(f"  {kind} profiled burst: "
                f"{json.dumps(timings[kind]['profile'])}")
        finally:
            server.shutdown()
            server.server_close()
            batcher.close()
    return timings


# ---------------------------------------------------------------------------
# Phase 4: card (bf16, kernels) vs CPU (fp32, plain versions)
# ---------------------------------------------------------------------------

def check_against_cpu(model, rng: np.random.Generator) -> float:
    from mae_clip_torch.data.tokenizer import WordPieceTokenizer, build_vocab
    from mae_clip_torch.models import CLIPModel
    from mae_clip_torch.eval.retrieval import _image_embed_fn, _text_embed_fn

    cpu = CLIPModel(model.cfg.replace(compute_dtype="float32"),
                    model.text_config, model.vit_config, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    tok = WordPieceTokenizer(build_vocab(CORPUS * 4, vocab_size=256))
    enc = tok.encode_batch(CORPUS[:4], max_length=FIXED_LENGTH)
    ids = np.asarray(enc["input_ids"])
    mask = np.asarray(enc["attention_mask"])
    size = model.cfg.size
    images = rng.integers(0, 256, (4, size, size, 3), np.uint8)
    worst = 1.0
    for what, card, host in (
            ("text", _text_embed_fn(model)(ids, mask),
             _text_embed_fn(cpu)(ids, mask)),
            ("image", _image_embed_fn(model)(images),
             _image_embed_fn(cpu)(images))):
        cos = torch.nn.functional.cosine_similarity(card.cpu(), host, dim=-1)
        log(f"  {what}: row cosine card bf16 vs CPU fp32 "
            f"{[round(float(c), 5) for c in cos]}")
        worst = min(worst, float(cos.min()))
    if worst < 0.99:
        raise AssertionError(f"card vs CPU embedding cosine {worst} < 0.99")
    return worst


# ---------------------------------------------------------------------------
# Phase 6: the flagship training step at batch 256
# ---------------------------------------------------------------------------

TRAIN_BATCH = 256
TRAIN_SEQ = 64       # caption length of the cached text features (bench.py)
# Kernel launches per step: 12 encoder blocks (packed qkv) and 4 CrossMAE
# decoder blocks (flash), forward and backward; the text tower is cached,
# and the masked patch embedding takes the default route (not opted in).
LAUNCHES_PER_STEP = {"qkv_packed_attention": 12,
                     "qkv_packed_attention_bwd": 12,
                     "flash_attention": 4, "flash_attention_bwd": 4,
                     "masked_patch_embed": 0, "fused_block_stack": 0,
                     "fused_block_stack_bwd": 0, "fused_block_stack_state": 0}
# With fused_blocks='on' the encoder and the CrossMAE decoder are one stack
# each (#6 forward, keeping its state, and #7 backward) and no attention
# kernel runs on its own; with 'fwd' the backward is the per-block plain
# recompute (no #7, and no state kept).
FUSED_LAUNCHES_PER_STEP = {
    "on": dict(LAUNCHES_PER_STEP, qkv_packed_attention=0,
               qkv_packed_attention_bwd=0, flash_attention=0,
               flash_attention_bwd=0, fused_block_stack=2,
               fused_block_stack_bwd=2, fused_block_stack_state=2),
    "fwd": dict(LAUNCHES_PER_STEP, qkv_packed_attention=0,
                qkv_packed_attention_bwd=0, flash_attention=0,
                flash_attention_bwd=0, fused_block_stack=2,
                fused_block_stack_bwd=0, fused_block_stack_state=0)}
TRAIN_DATA_SEED = 10  # one batch set for every training path


class Captions:
    """The two arrays ``precompute_text_features`` reads."""

    def __init__(self, input_ids: np.ndarray, attention_mask: np.ndarray):
        self.input_ids, self.attention_mask = input_ids, attention_mask


def build_train_model(batch: int, compute_dtype: str, device: str,
                      seed: int = 0, preset: str = "flagship_tpu_config",
                      text_config=None, **cfg):
    """``preset`` (a config function of ``mae_clip_torch``) with ``cfg``
    over it, DistilBERT as ``text_config`` (default: HF's, dropout 0.1),
    random weights from ``seed``."""
    import mae_clip_torch
    from mae_clip_torch.models import CLIPModel, DistilBertConfig

    cfg = getattr(mae_clip_torch, preset)(batch_size=batch,
                                          compute_dtype=compute_dtype, **cfg)
    model = CLIPModel(cfg, text_config or DistilBertConfig(), device=device)
    return model.init_weights(torch.Generator().manual_seed(seed))


def _synced_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def train_flagship(fused_blocks: str = "off",
                   launches_per_step: dict = LAUNCHES_PER_STEP,
                   preset: str = "flagship_tpu_config",
                   require_fall: bool = True, **overrides) -> tuple:
    """``make_train_step`` on the flagship model at batch 256, bf16, with
    ``fused_blocks`` as given and ``preset`` (with ``overrides``) as its
    config: text features cached once by the frozen tower, uint8 patches
    (B, 196, 768) in two batches cycled (the same data for every path).
    Checks the trainable weights move and the frozen ones do not, every
    kernel launches exactly ``launches_per_step`` times per step, and, with
    ``require_fall``, that the loss falls over 10 steps on one batch."""
    from mae_clip_torch.train import (TrainState, make_optimizer,
                                      make_train_step,
                                      precompute_text_features)

    rng = np.random.default_rng(TRAIN_DATA_SEED)
    torch.cuda.reset_peak_memory_stats()
    model = build_train_model(TRAIN_BATCH, "bfloat16", "cuda", preset=preset,
                              fused_blocks=fused_blocks, **overrides)
    cfg, dev = model.cfg, model.device
    vocab = model.text_config.vocab_size
    captions = Captions(
        rng.integers(0, vocab, (2 * TRAIN_BATCH, TRAIN_SEQ)),
        np.ones((2 * TRAIN_BATCH, TRAIN_SEQ), np.int64))
    t0 = time.perf_counter()
    feats = precompute_text_features(model, captions, TRAIN_BATCH)
    text_ms = (time.perf_counter() - t0) * 1e3
    vcfg = model.image_encoder.config
    n_patches, patch_dim = vcfg.num_patches, vcfg.patch_size ** 2 * 3
    batches = [{
        "image": torch.from_numpy(rng.integers(
            0, 256, (TRAIN_BATCH, n_patches, patch_dim), np.uint8)).to(dev),
        "text_features": torch.from_numpy(
            feats[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]).to(dev),
        "valid": torch.ones(TRAIN_BATCH, dtype=torch.bool, device=dev)}
        for i in range(2)]

    opt = make_optimizer(cfg, model)
    state = TrainState.create(model, opt, seed=0)
    step = make_train_step(model, opt, cfg)
    trainable = {n: p.detach().clone() for n, p in model.named_parameters()
                 if p.requires_grad}
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    if not frozen or not all(n.startswith("text_encoder") for n in frozen):
        raise AssertionError("the frozen parameters are not the text tower's")

    steps = 0

    def run(batch):
        nonlocal steps
        steps += 1
        return step(state, batch)

    counts = _reset_counts()
    losses = [run(batches[0]) for _ in range(10)]
    losses = [{k: float(v) for k, v in m.items()} for m in losses]
    total = [m["loss"] for m in losses]
    if not all(np.isfinite(list(m.values())).all() for m in losses):
        raise AssertionError(f"non-finite training metrics: {losses}")
    log(f"  loss over 10 steps on one batch: {[round(x, 4) for x in total]}")
    if require_fall and not np.mean(total[-3:]) < np.mean(total[:3]):
        raise AssertionError(f"the loss did not fall: {total}")

    for i in range(3):
        run(batches[i % 2])
    synced = [_synced_ms(lambda i=i: run(batches[i % 2]))
              for i in range(20)]
    pipelined = _synced_ms(lambda: [run(batches[i % 2])
                                    for i in range(20)]) / 20
    prof = profile_window(lambda: [run(batches[i % 2]) for i in range(5)],
                          top=10, spans=STEP_SPANS,
                          check=lambda window: step_stages(window, 5))
    stages = step_stages(prof, 5)
    launches = _read_counts(counts)
    per_step = {name: n / steps for name, n in launches.items()}
    log(f"  kernel launches on the training path ({steps} steps): "
        f"{launches}; per step {per_step}")
    for name, n in launches_per_step.items():
        if launches[name] != n * steps:
            raise AssertionError(f"{name}: {launches[name]} launches in "
                                 f"{steps} steps, expected {n} per step")

    moved = [n for n, p in model.named_parameters()
             if p.requires_grad and not torch.equal(p.detach(), trainable[n])]
    if len(moved) != len(trainable):
        raise AssertionError(f"{len(trainable) - len(moved)} trainable "
                             "tensors did not change")
    for n, p in model.named_parameters():
        if not p.requires_grad and not torch.equal(p.detach(), frozen[n]):
            raise AssertionError(f"frozen {n} changed")

    median = float(np.median(synced))
    result = dict(batch=TRAIN_BATCH, fused_blocks=fused_blocks,
                  preset=preset, overrides=overrides, text_cache_ms=text_ms,
                  step_ms_median=median, step_ms_min=float(np.min(synced)),
                  step_ms_pipelined=pipelined,
                  pairs_per_s=TRAIN_BATCH / median * 1e3,
                  pairs_per_s_pipelined=TRAIN_BATCH / pipelined * 1e3,
                  last_metrics={k: float(v) for k, v in
                                step(state, batches[0]).items()},
                  profile_5_steps=prof, launches=launches,
                  peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"  step ms (each synchronised, median of 20) {median:.3f}, min "
        f"{result['step_ms_min']:.3f}; 20 steps back to back "
        f"{pipelined:.3f} ms per step; pairs/s {result['pairs_per_s']:.1f} "
        f"(back to back {result['pairs_per_s_pipelined']:.1f}); text cache "
        f"of {2 * TRAIN_BATCH} captions {text_ms:.1f} ms; peak memory "
        f"{result['peak_memory_gb']:.2f} GB")
    result["stages"] = stages
    for name in ("logit_scale", "logit_bias"):
        if hasattr(model, name):
            value = float(getattr(model, name).detach())
            result[name] = value
            log(f"  {name} after {state.step} steps: {value:.6f} (exp "
                f"{math.exp(value):.6f})")
    if state.ema is not None:
        if not all(bool(torch.isfinite(e).all()) for e in state.ema.values()):
            raise AssertionError("non-finite EMA weights")
        result["ema_tensors"] = len(state.ema)
    log(f"  profiled 5 steps: {json.dumps(prof)}")
    log(f"  stages of one step (mean of the 5 profiled steps): "
        f"{json.dumps(stages)}")
    return launches, result


# make_train_step's spans: the forward, the backward, the optimizer's step
# (torch.optim's span, its clip and schedule hooks included; one of the
# three) and, with a learnable temperature or EMA, the clamp and the EMA.
OPTIMIZER_SPANS = tuple(f"Optimizer.step#{name}.step"
                        for name in ("AdamW", "Lamb", "Lion"))
POST_UPDATE_SPAN = "train_step.post_update"
STEP_SPANS = ("train_step.forward", "train_step.backward", *OPTIMIZER_SPANS,
              POST_UPDATE_SPAN)


def step_stages(prof: dict, steps: int) -> dict:
    """Per step, from ``make_train_step``'s own spans in a profiled window:
    each stage's host ms (the profiler's overhead included), its device ms
    and, for the update (the optimizer's step and the post-update span
    together), its kernels. The autograd engine launches the backward's
    kernels from its own thread, outside the span, so the backward's device
    ms is the window's busy time less the other stages'."""
    spans = prof["spans"]
    fwd, bwd = spans["train_step.forward"], spans["train_step.backward"]
    opt = [spans[n] for n in OPTIMIZER_SPANS if spans[n]["count"]]
    update = opt + ([spans[POST_UPDATE_SPAN]]
                    if spans[POST_UPDATE_SPAN]["count"] else [])
    if len(opt) != 1:
        raise AssertionError(f"{len(opt)} optimizer spans in the window")
    for name, span in (("forward", fwd), ("backward", bwd),
                       ("update", update[0]), ("post-update", update[-1])):
        if span["count"] != steps:
            raise AssertionError(f"{name}: {span['count']} spans in {steps} "
                                 "profiled steps")
        if (name != "backward" and torch.cuda.is_available()
                and span["device_count"] != steps):
            raise AssertionError(f"{name}: {span['device_count']} extents "
                                 f"on the device in {steps} steps")
    upd_device = sum(u["device_ms"] for u in update)
    return dict(
        forward_host_ms=fwd["host_ms"] / steps,
        backward_host_ms=bwd["host_ms"] / steps,
        optimizer_host_ms=sum(u["host_ms"] for u in update) / steps,
        forward_device_ms=fwd["device_ms"] / steps,
        backward_device_ms=(prof["device_busy_ms"] - fwd["device_ms"]
                            - upd_device) / steps,
        optimizer_device_ms=upd_device / steps,
        optimizer_launches=sum(u["launches"] for u in update) / steps)


# ---------------------------------------------------------------------------
# Phase 7: one training step on the card against one on the CPU
# ---------------------------------------------------------------------------

def check_train_step_against_cpu(rng: np.random.Generator,
                                 fused_blocks: str = "off",
                                 preset: str = "flagship_tpu_config",
                                 steps: int = 1, tokens: bool = False,
                                 cpu_overrides: Optional[dict] = None,
                                 **overrides) -> dict:
    """The flagship step at full width, B=8, dropout 0, the same weights and
    masks, with ``fused_blocks`` as given and ``preset`` (with
    ``overrides``) as its config: the card in bf16 with the kernels, the CPU
    in fp32 with the plain versions, ``steps`` steps each. With ``tokens``
    the text tower reads token ids (S=64) with padding masks instead of
    cached features (train it with ``text_trainable=True``). Each side's
    step accumulates over its config's ``accum_steps``; ``cpu_overrides``
    change the CPU's config (phase 15 holds the card's GradCache step
    against the CPU's one pass over the batch). After the last
    step: losses within 2e-2 relative; every trainable gradient with cosine
    >= 0.99 to the CPU's, but those that are 0 in exact arithmetic (their
    CPU norm below 1e-6 of the largest; the card's must stay below 1e-3 of
    it) and the 0-d logit parameters', which must agree
    within 2e-2 relative to the larger of their CPU gradient and that
    gradient's terms before they cancel (``logit_grad_terms``); after two
    steps or more every trainable parameter and EMA tensor with cosine >=
    0.99 where it was not zero at the start (the update's own cosine is
    reported), and the card's parameters and EMA within 1e-6 + 1e-5 |x| of
    its optimizer replayed on the CPU from the card's own gradients.
    Returns the card's kernel launches over its steps too."""
    from mae_clip_torch.models import CLIPModel, DistilBertConfig
    from mae_clip_torch.ops.masking import MaskingResult, random_masking
    from mae_clip_torch.train import (TrainState, make_optimizer,
                                      make_train_step)
    from mae_clip_torch.train.loop import _forward, _update

    b = 8
    text_config = DistilBertConfig(dropout=0.0, attention_dropout=0.0)
    card = build_train_model(b, "bfloat16", "cuda", seed=1, preset=preset,
                             text_config=text_config, dropout=0.0,
                             fused_blocks=fused_blocks, **overrides)
    cpu = CLIPModel(card.cfg.replace(compute_dtype="float32",
                                     **(cpu_overrides or {})),
                    card.text_config, card.vit_config, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    vcfg = card.image_encoder.config
    batches, maskings = [], []
    for i in range(steps):
        maskings.append(random_masking(
            b, vcfg.num_patches, card.cfg.mae.mask_ratio,
            torch.Generator().manual_seed(3 + i)))
        batch = {"image": torch.from_numpy(rng.integers(
                     0, 256, (b, vcfg.num_patches, vcfg.patch_size ** 2 * 3),
                     np.uint8)),
                 "valid": torch.ones(b, dtype=torch.bool)}
        if tokens:
            batch["input_ids"] = torch.from_numpy(rng.integers(
                0, card.text_config.vocab_size, (b, TRAIN_SEQ)))
            batch["attention_mask"] = _padding_mask(
                torch.Generator().manual_seed(5 + i), b, TRAIN_SEQ,
                "cpu").long()
        else:
            batch["text_features"] = torch.from_numpy(rng.normal(
                size=(b, card.text_config.dim)).astype(np.float32))
        batches.append(batch)
    before = {n: p.detach().float().cpu().clone()
              for n, p in card.named_parameters() if p.requires_grad}
    replay = None
    if steps > 1:   # the card's optimizer, replayed on the CPU
        replay = CLIPModel(cpu.cfg, card.text_config, card.vit_config,
                           device="cpu")
        replay.load_state_dict(cpu.state_dict())
        replay_state = TrainState.create(
            replay, make_optimizer(replay.cfg, replay))
    metrics, grads, params, emas = [], [], [], []
    for model in (card, cpu):
        opt = make_optimizer(model.cfg, model)
        step = make_train_step(model, opt, model.cfg,
                               accum_steps=model.cfg.accum_steps)
        state = TrainState.create(model, opt)
        counts = _reset_counts()
        for batch, masking in zip(batches, maskings):
            masking = MaskingResult(*(x.to(model.device) for x in masking))
            if model is cpu:   # the last step's embeddings (dropout 0)
                with torch.no_grad():
                    out = _forward(model, batch, True, None, model.cfg,
                                   masking)
            m = step(state, batch, masking=masking)
            if model is card and replay is not None:
                live = dict(card.named_parameters())
                for n, p in replay.named_parameters():
                    if p.requires_grad:   # the card's clipped gradients
                        p.grad = live[n].grad.float().cpu()
                _update(replay_state, replay.cfg)
        if model is card:
            launches = _read_counts(counts)
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append({n: p.grad.float().cpu()
                      for n, p in model.named_parameters() if p.requires_grad})
        params.append({n: p.detach().float().cpu().clone()
                       for n, p in model.named_parameters() if p.requires_grad})
        emas.append({n: e.float().cpu().clone()
                     for n, e in (state.ema or {}).items()})
    log(f"  metrics card bf16 {metrics[0]} vs CPU fp32 {metrics[1]}")
    for k, want in metrics[1].items():
        if abs(metrics[0][k] - want) > 2e-2 * abs(want):
            raise AssertionError(f"{k}: card {metrics[0][k]} vs CPU {want}")
    terms = logit_grad_terms(cpu, out["image_embeddings"],
                             out["text_embeddings"])
    logit = {n: (float(g), float(grads[1][n]), terms[n])
             for n, g in grads[0].items() if n.startswith("logit_")}
    log(f"  logit gradients card vs CPU (and the CPU's terms before they "
        f"cancel): {logit}")
    for n, (got, want, total) in logit.items():
        if abs(got - want) > 2e-2 * max(abs(want), total):
            raise AssertionError(f"{n} gradient: card {got} vs CPU {want} "
                                 f"(terms {total})")

    def lowest(a: dict, b: dict, what: str, names=None) -> tuple:
        cos = {n: float(torch.nn.functional.cosine_similarity(
            x.flatten(), b[n].flatten(), dim=0))
            for n, x in a.items()
            if n not in logit and (names is None or n in names)}
        worst = sorted(cos.items(), key=lambda kv: kv[1])[:5]
        log(f"  {what} cosine card vs CPU over {len(cos)} tensors: lowest "
            f"{[(n, round(c, 5)) for n, c in worst]}")
        return worst[0] if worst else (None, 1.0)

    # A gradient that is 0 in exact arithmetic (the text tower's key
    # biases: a constant per row of scores) is rounding on both sides; it
    # is held by its size, not its direction.
    big = max(float(g.norm()) for g in grads[1].values())
    zero = {n for n, g in grads[1].items() if float(g.norm()) <= 1e-6 * big}
    stray = {n: float(grads[0][n].norm()) for n in zero}
    if stray:
        log(f"  gradients 0 in exact arithmetic, card norms (limit "
            f"{1e-3 * big:.3g}): {stray}")
    if any(v > 1e-3 * big for v in stray.values()):
        raise AssertionError(f"gradients that should be 0: {stray}")
    worst = lowest(grads[0], grads[1], "gradient", set(grads[1]) - zero)
    result = dict(metrics=metrics, min_grad_cosine=worst[1],
                  logit_grads=logit, launches=launches,
                  text_layers=card.text_config.n_layers)
    checks = [worst]
    if replay is not None:
        # A tensor that starts at zero (the biases) is its own update after
        # the steps, and the first Adam-family updates are sign-like, so
        # bf16 turns some of their entries: those are held by the replay.
        nonzero = {n for n, p in before.items() if bool(p.any())}
        checks.append(lowest(params[0], params[1], "parameter", nonzero))
        result["min_param_cosine"] = checks[-1][1]
        if emas[0]:
            checks.append(lowest(emas[0], emas[1], "EMA", nonzero))
            result["min_ema_cosine"] = checks[-1][1]
        result["min_update_cosine"] = lowest(
            {n: p - before[n] for n, p in params[0].items()},
            {n: p - before[n] for n, p in params[1].items()},
            "update (reported, not held)")[1]
        replayed = [(params[0], dict(replay.named_parameters()))]
        if emas[0]:
            replayed.append((emas[0], replay_state.ema))
        err = max(float(((got[n] - want[n].detach()).abs()
                         - 1e-5 * want[n].detach().abs()).max())
                  for got, want in replayed for n in got)
        log(f"  the card's parameters and EMA after {steps} steps against "
            f"its optimizer replayed on the CPU from its gradients: largest "
            f"|diff| - 1e-5 |ref| = {err:.3g} (limit 1e-6)")
        result["replay_err"] = err
        if err > 1e-6:
            raise AssertionError(f"the card's optimizer against its CPU "
                                 f"replay: {err}")
    for name, c in checks:
        if c < 0.99:
            raise AssertionError(f"cosine of {name} {c} < 0.99")
    return result


def logit_grad_terms(model, img: torch.Tensor, txt: torch.Tensor) -> dict:
    """For each 0-d logit parameter p of ``model``'s contrastive loss,
    ``sum |dL/dz_ij * dz_ij/dp|`` over the logits z of the (B, B) pair
    matrix: its gradient's terms before they cancel. At random weights the
    pairs' cosines are ~0 either side of 0, so the scale's gradient is a
    small rest of larger terms, and bf16 embeddings move it by a share of
    those terms, not of itself. SigLIP: z = exp(s) c + b; the learnable
    temperature (hard labels, all rows valid): z = c min(exp(s), 100)."""
    cfg = model.cfg
    img = torch.nn.functional.normalize(img.float(), dim=-1)
    txt = torch.nn.functional.normalize(txt.float(), dim=-1)
    b = img.shape[0]
    eye = torch.eye(b)
    if cfg.contrastive_loss == "siglip":
        c = img @ txt.T
        z = torch.exp(model.logit_scale.detach()) * c
        labels = 2.0 * eye - 1.0
        dz = -labels * torch.sigmoid(-labels * (z + model.logit_bias.detach()))
        dz = dz / b
        return {"logit_scale": float((dz * z).abs().sum()),
                "logit_bias": float(dz.abs().sum())}
    if cfg.learnable_temperature and cfg.contrastive_loss == "clip":
        z = (txt @ img.T) * torch.clamp(
            torch.exp(model.logit_scale.detach()), max=100.0)
        dz = (torch.softmax(z, 1) - eye + (torch.softmax(z, 0) - eye)) / (2 * b)
        return {"logit_scale": float((dz * z).abs().sum())}
    return {}


# ---------------------------------------------------------------------------
# Phases 12-13: the SigLIP step and the other training options
# ---------------------------------------------------------------------------

# The second run of phase 12 and check (c) of phase 13.
LAMB_OVERRIDES = dict(optimizer="lamb", lr_schedule="cosine", warmup_steps=2,
                      decay_steps=100, grad_clip_norm=1.0, ema_decay=0.999)


def train_siglip() -> tuple:
    """Phase 12: ``flagship_siglip_config``'s step at batch 256, bf16, per
    block, on phase 6's data: as the preset is (AdamW, constant lr), then
    with ``LAMB_OVERRIDES``. Both launch 12 / 12 / 4 / 4 of #1 / #3 / #2 /
    #4 a step. The LAMB run's loss is not required to fall in 10 steps: its
    first update has lr 0 and LAMB moves each tensor by ~lr of its norm."""
    launches, adamw = train_flagship(preset="flagship_siglip_config")
    _, lamb = train_flagship(preset="flagship_siglip_config",
                             require_fall=False, **LAMB_OVERRIDES)
    a, b = adamw["stages"], lamb["stages"]
    log(f"  optimizer stage per step, AdamW vs LAMB + cosine + clip + EMA: "
        f"device {a['optimizer_device_ms']:.4f} vs "
        f"{b['optimizer_device_ms']:.4f} ms, host "
        f"{a['optimizer_host_ms']:.4f} vs {b['optimizer_host_ms']:.4f} ms, "
        f"kernels {a['optimizer_launches']:.1f} vs "
        f"{b['optimizer_launches']:.1f}")
    for run in (adamw, lamb):
        if run["logit_bias"] <= -10.0:
            raise AssertionError(f"logit_bias did not rise from -10: "
                                 f"{run['logit_bias']}")
    adamw["lamb"] = lamb
    return launches, adamw


def check_siglip_options_against_cpu(rng: np.random.Generator) -> dict:
    """Phase 13: card (bf16, kernels) against CPU (fp32, plain versions),
    B=8, full width, dropout 0, with phase 7's limits: (a) SigLIP; (b) the
    hard-label loss with the learnable temperature; (c) (a) with
    ``LAMB_OVERRIDES`` over two steps; (d) a trained text tower on tokens
    with padding masks, which runs #2 / #4 (6 layers, plus the decoder's
    4). Then one step on the card with attention dropout 0.1, whose text
    tower takes the plain route and launches neither."""
    from mae_clip_torch.train import (TrainState, make_optimizer,
                                      make_train_step)

    out = {}
    log("  (a) SigLIP, one step")
    out["siglip"] = check_train_step_against_cpu(
        rng, preset="flagship_siglip_config")
    log("  (b) hard-label loss, learnable temperature, one step")
    out["clip_learnable_temperature"] = check_train_step_against_cpu(
        rng, contrastive_loss="clip", learnable_temperature=True)
    log("  (c) SigLIP with LAMB, cosine, clipping and EMA, two steps")
    out["siglip_lamb_ema"] = check_train_step_against_cpu(
        rng, preset="flagship_siglip_config", steps=2, **LAMB_OVERRIDES)
    log("  (d) trained text tower on tokens (S=64, padding masks), attention "
        "dropout 0, one step")
    out["text_trained"] = check_train_step_against_cpu(
        rng, tokens=True, text_trainable=True)
    launched = out["text_trained"]["launches"]
    flash = {k: launched[k]
             for k in ("flash_attention", "flash_attention_bwd")}
    want = (out["text_trained"]["text_layers"]
            + LAUNCHES_PER_STEP["flash_attention"])
    if flash != {"flash_attention": want, "flash_attention_bwd": want}:
        raise AssertionError(f"trained text tower: #2 / #4 launches {flash}, "
                             f"expected {want} each")

    model = build_train_model(8, "bfloat16", "cuda", seed=1,
                              text_trainable=True)
    opt = make_optimizer(model.cfg, model)
    vcfg = model.image_encoder.config
    batch = {"image": torch.from_numpy(rng.integers(
                 0, 256, (8, vcfg.num_patches, vcfg.patch_size ** 2 * 3),
                 np.uint8)),
             "input_ids": torch.from_numpy(rng.integers(
                 0, model.text_config.vocab_size, (8, TRAIN_SEQ))),
             "attention_mask": _padding_mask(
                 torch.Generator().manual_seed(9), 8, TRAIN_SEQ,
                 "cpu").long()}
    counts = _reset_counts()
    loss = float(make_train_step(model, opt, model.cfg)(
        TrainState.create(model, opt), batch)["loss"])
    dropped = {k: v for k, v in _read_counts(counts).items()
               if k.startswith("flash")}
    log(f"  attention dropout 0.1: loss {loss:.6f}, #2 / #4 launches "
        f"{dropped} (the decoder's alone)")
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss with attention dropout: {loss}")
    if set(dropped.values()) != {LAUNCHES_PER_STEP["flash_attention"]}:
        raise AssertionError(f"the text tower launched #2 / #4 with "
                             f"attention dropout: {dropped}")
    out["attention_dropout"] = dict(loss=loss, launches=dropped)
    return out


def check_fused_serving_tower(rng: np.random.Generator) -> float:
    """``encode_full`` (through ``CLIPModel.encode_image`` and the image
    projection) of 64 uint8 images on the card, bf16: the flagship model
    with ``fused_blocks='on'`` (#6 over 12 blocks at S=197) against the same
    weights per block ('off'). Row cosine >= 0.99."""
    from mae_clip_torch.eval.retrieval import _image_embed_fn

    fused = build_train_model(64, "bfloat16", "cuda", seed=2,
                              fused_blocks="on")
    plain = build_train_model(64, "bfloat16", "cuda", seed=2)
    plain.load_state_dict(fused.state_dict())
    size = fused.cfg.size
    images = rng.integers(0, 256, (64, size, size, 3), np.uint8)
    counts = _reset_counts()
    got = _image_embed_fn(fused)(images)
    launched, states = (_read_counts(counts)[k] for k in (
        "fused_block_stack", "fused_block_stack_state"))
    want = _image_embed_fn(plain)(images)
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    log(f"  encode_full of 64 images, fused vs per block on the card: "
        f"lowest row cosine {float(cos.min()):.6f}; #6 launched {launched} "
        "time(s)")
    if launched != 1:
        raise AssertionError(f"encode_full launched #6 {launched} times")
    if states:
        raise AssertionError(f"encode_full kept {states} training states")
    if float(cos.min()) < 0.99:
        raise AssertionError(f"fused encode_full cosine {float(cos.min())}"
                             " < 0.99")
    return float(cos.min())


# ---------------------------------------------------------------------------
# Phases 14-15: large_batch_mesh_config on one card
# ---------------------------------------------------------------------------

LARGE_PRESET = "large_batch_mesh_config"
LARGE_BATCH = 32768
LARGE_DATA_SEED = 12


def large_batch_launches(model) -> dict:
    """Kernel launches per step of a GradCache step of ``model`` (MAE
    'full' decoder, cached text, per block): per microbatch #1 runs
    without lse over the encoder's and the decoder's blocks in pass 1,
    with lse over both in pass 2 and again over the encoder's when remat
    recomputes them; #3 once per block."""
    k = model.cfg.accum_steps
    enc = len(model.image_encoder.blocks)
    dec = len(model.image_encoder.decoder_blocks)
    again = enc if model.cfg.remat else 0
    return dict(LAUNCHES_PER_STEP, flash_attention=0, flash_attention_bwd=0,
                qkv_packed_attention=k * (2 * (enc + dec) + again),
                qkv_packed_attention_bwd=k * (enc + dec))


def _large_batch(model, rows: int, seed: int) -> dict:
    """uint8 patches and cached text features (fp32), made on the model's
    device from ``seed``; every row valid."""
    dev = model.device
    vcfg = model.image_encoder.config
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {"image": torch.randint(
                0, 256, (rows, vcfg.num_patches, vcfg.patch_size ** 2 * 3),
                dtype=torch.uint8, device=dev, generator=gen),
            "text_features": torch.randn(rows, model.text_config.dim,
                                         device=dev, generator=gen),
            "valid": torch.ones(rows, dtype=torch.bool, device=dev)}


def _pass2_peak(model, batch: dict, masking) -> dict:
    """Peak device memory of one microbatch's pass 2 (the forward with
    autograd recording, then the backward of its embeddings and MAE loss),
    or the out-of-memory error's first line; ``base_gb`` is what was
    allocated before it."""
    from mae_clip_torch.train.loop import _forward

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        out = _forward(model, batch, True, None, model.cfg, masking)
        ys = [out["image_embeddings"], out["text_embeddings"],
              out["mae_loss"]]
        torch.autograd.backward(ys, [torch.full_like(y, 1e-4) for y in ys])
        del out, ys
        torch.cuda.synchronize()
        result = dict(peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    except torch.cuda.OutOfMemoryError as e:
        result = dict(oom=str(e).splitlines()[0])
    model.zero_grad(set_to_none=True)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(result, base_gb=base / 1e9)


def train_large_batch() -> tuple:
    """Phase 14: ``large_batch_mesh_config`` as the preset is (GradCache
    over 8 microbatches of 4,096, the chunked soft-target loss at 4,096
    columns, LAMB, per-block remat of the encoder, the MAE-paper decoder)
    at batch 32,768 in bf16 on one card, uint8 patches and cached text
    features made on the card. One warm-up step, then two steps under the
    profiler: wall and device ms a step, pairs/s, the busy share, the
    stages; every kernel launching exactly ``large_batch_launches`` a step;
    finite losses; every trainable tensor moved. Then one microbatch's
    pass 2 alone, with remat and without (its peak memory, or the OOM)."""
    from mae_clip_torch.ops.masking import random_masking
    from mae_clip_torch.train import (TrainState, make_optimizer,
                                      make_train_step)
    from mae_clip_torch.train.loop import _microbatches

    torch.cuda.reset_peak_memory_stats()
    model = build_train_model(LARGE_BATCH, "bfloat16", DEVICE.type,
                              preset=LARGE_PRESET)
    cfg = model.cfg
    batch = _large_batch(model, LARGE_BATCH, LARGE_DATA_SEED)
    opt = make_optimizer(cfg, model)
    state = TrainState.create(model, opt, seed=0)
    step = make_train_step(model, opt, cfg, accum_steps=cfg.accum_steps)
    per_step = large_batch_launches(model)
    trainable = {n: p.detach().clone() for n, p in model.named_parameters()
                 if p.requires_grad}
    data_gb = sum(t.numel() * t.element_size() for t in batch.values()) / 1e9
    log(f"  batch {LARGE_BATCH}: {cfg.accum_steps} microbatches, loss "
        f"chunks of {cfg.loss_chunk_size}, {cfg.optimizer}, remat "
        f"{cfg.remat}, decoder '{cfg.mae.decoder_style}'; data "
        f"{data_gb:.2f} GB on the card")

    metrics, steps = [], 0

    def run():
        nonlocal steps
        steps += 1
        metrics.append(step(state, batch))

    counts = _reset_counts()
    warm_ms = _synced_ms(run)
    prof = profile_window(lambda: [run() for _ in range(2)], top=10,
                          spans=STEP_SPANS,
                          check=lambda window: step_stages(window, 2))
    stages = step_stages(prof, 2)
    launches = _read_counts(counts)
    peak = torch.cuda.max_memory_allocated() / 1e9
    values = [{k: float(v) for k, v in m.items()} for m in metrics]
    log(f"  metrics of the {steps} steps: {values}")
    if not all(np.isfinite(list(m.values())).all() for m in values):
        raise AssertionError(f"non-finite metrics: {values}")
    log(f"  kernel launches ({steps} steps): {launches}; expected per step "
        f"{per_step}")
    for name, n in per_step.items():
        if launches[name] != n * steps:
            raise AssertionError(f"{name}: {launches[name]} launches in "
                                 f"{steps} steps, expected {n} per step")
    moved = [n for n, p in model.named_parameters()
             if p.requires_grad and not torch.equal(p.detach(), trainable[n])]
    if len(moved) != len(trainable):
        raise AssertionError(f"{len(trainable) - len(moved)} trainable "
                             "tensors did not change")
    del trainable
    wall = prof["wall_ms"] / 2
    device = prof["device_busy_ms"] / 2
    result = dict(batch=LARGE_BATCH, accum_steps=cfg.accum_steps,
                  loss_chunk_size=cfg.loss_chunk_size, remat=cfg.remat,
                  warmup_ms=warm_ms, step_ms_profiled=wall,
                  device_ms=device, busy_share=prof["busy_share"],
                  pairs_per_s=LARGE_BATCH / wall * 1e3, stages=stages,
                  metrics=values, launches=launches, peak_memory_gb=peak,
                  profile_2_steps=prof)
    log(f"  warm-up step {warm_ms:.1f} ms; two steps under the profiler: "
        f"{wall:.1f} ms wall and {device:.1f} ms device a step, busy "
        f"{prof['busy_share']:.3f}, {result['pairs_per_s']:.1f} pairs/s; "
        f"peak memory {peak:.2f} GB")
    log(f"  stages of one step: {json.dumps(stages)}")
    log(f"  profiled 2 steps: {json.dumps(prof)}")

    rows = LARGE_BATCH // cfg.accum_steps
    masking = random_masking(LARGE_BATCH, model.image_encoder.config
                             .num_patches, cfg.mae.mask_ratio,
                             torch.Generator(device=model.device)
                             .manual_seed(1))
    first, first_masking = _microbatches(batch, masking, cfg.accum_steps)[0]
    probe = {}
    for remat in (True, False):
        model.image_encoder.remat = remat
        probe["remat" if remat else "no_remat"] = _pass2_peak(
            model, first, first_masking)
    model.image_encoder.remat = cfg.remat
    log(f"  one microbatch of {rows}, pass 2 alone: {json.dumps(probe)}")
    if "oom" in probe["remat"]:
        raise AssertionError(f"a microbatch of {rows} does not fit with "
                             f"remat: {probe['remat']}")
    result["pass2_microbatch"] = probe
    del model, opt, state, step, batch, first, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return launches, result


def check_chunked_losses(rows: int = 16384, dim: int = 256,
                         chunks=(4096, 3000), memory_rows: int = 32768,
                         memory_chunk: int = 4096) -> dict:
    """Phase 15 (a): the chunked soft (T=1) and hard (T=0.07) losses
    against the unchunked ones on the card, fp32 embeddings (rows, dim)
    with three padded rows, in chunks that divide the rows and that do not:
    the value within 1e-5 relative, both embedding gradients within 1e-5 of
    the largest entry. Then the peak memory of forward + backward: the
    unchunked losses at ``rows``, the chunked at ``rows`` and at
    ``memory_rows`` in chunks of ``memory_chunk``."""
    from mae_clip_torch.ops import losses as L

    gen = torch.Generator(device=DEVICE).manual_seed(11)

    def inputs(n):
        img, txt = (torch.randn(n, dim, device=DEVICE, generator=gen)
                    for _ in range(2))
        valid = torch.ones(n, dtype=torch.bool, device=DEVICE)
        valid[[5, n // 2, n - 1]] = False
        return img, txt, valid

    def value_and_grads(fn, img, txt, valid):
        img, txt = (x.detach().requires_grad_() for x in (img, txt))
        loss = fn(img, txt, valid)
        return (loss.detach(), *torch.autograd.grad(loss, (img, txt)))

    losses = {"soft": (L.clip_soft_ce_loss, L.clip_soft_ce_loss_chunked,
                       1.0),
              "hard": (L.clip_hard_ce_loss, L.clip_hard_ce_loss_chunked,
                       0.07)}
    img, txt, valid = inputs(rows)
    out = {}
    for name, (plain, chunked, t) in losses.items():
        want = value_and_grads(lambda i, x, v: plain(i, x, t, v), img, txt,
                               valid)
        for chunk in chunks:
            got = value_and_grads(
                lambda i, x, v: chunked(i, x, t, v, chunk), img, txt, valid)
            err = dict(value=float((got[0] - want[0]).abs() / want[0].abs()),
                       d_img=float((got[1] - want[1]).abs().max()
                                   / want[1].abs().max()),
                       d_txt=float((got[2] - want[2]).abs().max()
                                   / want[2].abs().max()))
            out[f"{name}_chunk_{chunk}"] = dict(err, loss=float(want[0]))
            log(f"  {name} loss at {rows} rows, chunks of {chunk}: "
                f"{float(got[0]):.6f} against {float(want[0]):.6f}; "
                f"relative errors {err}")
            if not all(e <= 1e-5 for e in err.values()):   # NaN fails
                raise AssertionError(f"chunked {name} loss, chunk {chunk}: "
                                     f"{err} (limit 1e-5)")
    del img, txt, valid, want, got

    def peak_gb(fn, n):
        img, txt, valid = inputs(n)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        value_and_grads(fn, img, txt, valid)
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 1e9

    memory = {}
    for name, (plain, chunked, t) in losses.items():
        memory[name] = {
            f"unchunked_{rows}": peak_gb(
                lambda i, x, v: plain(i, x, t, v), rows),
            f"chunked_{rows}_by_{memory_chunk}": peak_gb(
                lambda i, x, v: chunked(i, x, t, v, memory_chunk), rows),
            f"chunked_{memory_rows}_by_{memory_chunk}": peak_gb(
                lambda i, x, v: chunked(i, x, t, v, memory_chunk),
                memory_rows)}
    log(f"  peak GB of forward + backward above the inputs: "
        f"{json.dumps(memory)}")
    out["peak_gb"] = memory
    return out


def check_gradcache_against_giant_batch(batch: int = 64, accum: int = 4,
                                        chunk: int = 16) -> dict:
    """Phase 15 (b): ``large_batch_mesh_config`` at full width, bf16 on the
    card, dropout 0: GradCache (``accum`` microbatches, the chunked loss
    at ``chunk`` columns, remat) against the one-pass step (accum 1,
    unchunked, no remat) on the same weights, batch and masks, gradients
    read from ``.grad`` (SGD). Every metric within 1e-3 relative, every
    gradient cosine >= 0.999 and norm ratio within 1e-2 of 1 but those
    that are 0 in exact arithmetic (norm below 1e-6 of the largest; the
    other's below 1e-3 of it)."""
    from mae_clip_torch.ops.masking import MaskingResult, random_masking
    from mae_clip_torch.train import TrainState, make_train_step

    runs = []
    for kw in (dict(accum_steps=accum, loss_chunk_size=chunk, remat=True),
               dict(accum_steps=1, loss_chunk_size=0, remat=False)):
        model = build_train_model(batch, "bfloat16", DEVICE.type, seed=3,
                                  preset=LARGE_PRESET, dropout=0.0, **kw)
        data = _large_batch(model, batch, 14)
        vcfg = model.image_encoder.config
        masking = MaskingResult(*(x.to(model.device) for x in random_masking(
            batch, vcfg.num_patches, model.cfg.mae.mask_ratio,
            torch.Generator().manual_seed(4))))
        opt = torch.optim.SGD([p for p in model.parameters()
                               if p.requires_grad], lr=1.0)
        metrics = make_train_step(model, opt, model.cfg, accum_steps=model.cfg
                                  .accum_steps)(TrainState.create(model, opt),
                                                data, masking=masking)
        runs.append(({k: float(v) for k, v in metrics.items()},
                     {n: p.grad.float() for n, p in model.named_parameters()
                      if p.grad is not None}))
        del model, opt, data
    (got, got_g), (want, want_g) = runs
    log(f"  metrics GradCache {got} vs one pass {want}")
    for k, w in want.items():
        if abs(got[k] - w) > 1e-3 * abs(w):
            raise AssertionError(f"{k}: GradCache {got[k]} vs {w}")
    if set(got_g) != set(want_g):
        raise AssertionError("GradCache and the one-pass step trained "
                             "different tensors")
    big = max(float(g.norm()) for g in want_g.values())
    zero = {n for n, g in want_g.items() if float(g.norm()) <= 1e-6 * big}
    stray = {n: float(got_g[n].norm()) for n in zero}
    if any(v > 1e-3 * big for v in stray.values()):
        raise AssertionError(f"gradients that should be 0: {stray}")
    cos = {n: float(torch.nn.functional.cosine_similarity(
        got_g[n].flatten(), g.flatten(), dim=0))
        for n, g in want_g.items() if n not in zero}
    # The cosine misses a scale error (say pass 2's MAE cotangent off by
    # k), so each tensor's norm is held against the one pass's too.
    ratio = {n: float(got_g[n].norm() / g.norm())
             for n, g in want_g.items() if n not in zero}
    worst = sorted(cos.items(), key=lambda kv: kv[1])[:5]
    far = sorted(ratio.items(), key=lambda kv: -abs(kv[1] - 1))[:5]
    log(f"  gradient cosine over {len(cos)} tensors: lowest "
        f"{[(n, round(c, 6)) for n, c in worst]}; norm ratios farthest "
        f"from 1 {[(n, round(r, 6)) for n, r in far]}; 0 in exact "
        f"arithmetic {stray}")
    if worst[0][1] < 0.999:
        raise AssertionError(f"gradient cosine {worst[0]} < 0.999")
    if not abs(far[0][1] - 1) <= 1e-2:      # NaN fails
        raise AssertionError(f"gradient norm ratio {far[0]}: not within "
                             "1e-2 of 1")
    return dict(metrics=got, one_pass_metrics=want,
                min_grad_cosine=worst[0][1], worst_norm_ratio=far[0][1])


def check_large_batch_options(rng: np.random.Generator) -> dict:
    """Phase 15: (a) the chunked losses; (b) GradCache against the
    one-pass step on the card; (c) the card's
    GradCache step (accum 4, chunks of 3, remat) against the CPU's one pass
    over the batch at fp32, with phase 7's limits."""
    out = {}
    log("  (a) chunked against unchunked losses, fp32")
    out["chunked_losses"] = check_chunked_losses()
    log("  (b) GradCache against the one-pass step, B=64, bf16")
    out["gradcache"] = check_gradcache_against_giant_batch()
    log("  (c) the card's GradCache step against the CPU's one pass, B=8")
    out["against_cpu"] = check_train_step_against_cpu(
        rng, preset=LARGE_PRESET, accum_steps=4, loss_chunk_size=3,
        cpu_overrides=dict(accum_steps=1, loss_chunk_size=0, remat=False))
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 8: the MAE-pretrain step at batch 256
# ---------------------------------------------------------------------------

PRETRAIN_BATCH = 256
# Kernel launches per step: 12 encoder and 4 decoder blocks (packed qkv),
# forward and backward, and one masked patch embedding (forward only).
PRETRAIN_LAUNCHES_PER_STEP = {"qkv_packed_attention": 16,
                              "qkv_packed_attention_bwd": 16,
                              "masked_patch_embed": 1,
                              "flash_attention": 0, "flash_attention_bwd": 0,
                              "fused_block_stack": 0,
                              "fused_block_stack_bwd": 0,
                              "fused_block_stack_state": 0}


def build_pretrain_model(batch: int, compute_dtype: str, device: str,
                         seed: int = 0):
    """``mae_pretrain_config`` (ViT-S/16 with 3 heads of 128, the MAE-paper
    decoder: 4 blocks of 256 with 2 heads of 128) at full width, random
    weights from ``seed``, with the masked patch-embed kernel opted in (the
    JAX package's ``use_pallas_patch_embed``; off by default)."""
    from mae_clip_torch import mae_pretrain_config
    from mae_clip_torch.models import mae_vit_for

    cfg = mae_pretrain_config(batch_size=batch, compute_dtype=compute_dtype)
    model = mae_vit_for(cfg, device=device).init_weights(
        torch.Generator().manual_seed(seed))
    model.patch_embed.masked_kernel = True
    return cfg, model


def pretrain_mae(rng: np.random.Generator) -> tuple:
    """``make_mae_pretrain_step`` at batch 256, bf16: uint8 sources
    (256, 256, 256, 3) in two batches cycled, cropped to 224 and flipped in
    the step. Checks the loss falls over 10 steps on one batch, every weight
    moves, each kernel launches exactly as often per step as the model has
    blocks, and two evals at one state agree."""
    from mae_clip_torch.train import (TrainState, make_mae_eval_step,
                                      make_mae_pretrain_step, make_optimizer)

    torch.cuda.reset_peak_memory_stats()
    cfg, model = build_pretrain_model(PRETRAIN_BATCH, "bfloat16", "cuda")
    dev, src = model.device, cfg.mae.aug_source_size
    batches = [{
        "image": torch.from_numpy(rng.integers(
            0, 256, (PRETRAIN_BATCH, src, src, 3), np.uint8)).to(dev),
        "valid": torch.ones(PRETRAIN_BATCH, dtype=torch.bool, device=dev)}
        for _ in range(2)]
    opt = make_optimizer(cfg, model)
    state = TrainState.create(model, opt, seed=0, cfg=cfg)
    step = make_mae_pretrain_step(model, opt, cfg)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    steps = 0

    def run(batch):
        nonlocal steps
        steps += 1
        return step(state, batch)

    counts = _reset_counts()
    total = [float(run(batches[0])["loss"]) for _ in range(10)]
    if not np.isfinite(total).all():
        raise AssertionError(f"non-finite pretraining loss: {total}")
    log(f"  loss over 10 steps on one batch: {[round(x, 4) for x in total]}")
    if not np.mean(total[-3:]) < np.mean(total[:3]):
        raise AssertionError(f"the loss did not fall: {total}")
    for i in range(3):
        run(batches[i % 2])
    synced = [_synced_ms(lambda i=i: run(batches[i % 2]))
              for i in range(20)]
    pipelined = _synced_ms(lambda: [run(batches[i % 2])
                                    for i in range(20)]) / 20
    prof = profile_window(lambda: [run(batches[i % 2]) for i in range(5)],
                          top=10, spans=STEP_SPANS,
                          check=lambda window: step_stages(window, 5))
    launches = _read_counts(counts)
    per_step = {name: n / steps for name, n in launches.items()}
    log(f"  kernel launches on the pretraining path ({steps} steps): "
        f"{launches}; per step {per_step}")
    for name, n in PRETRAIN_LAUNCHES_PER_STEP.items():
        if launches[name] != n * steps:
            raise AssertionError(f"{name}: {launches[name]} launches in "
                                 f"{steps} steps, expected {n} per step")
    still = [n for n, p in model.named_parameters()
             if torch.equal(p.detach(), before[n])]
    if still:
        raise AssertionError(f"{len(still)} tensors did not change: "
                             f"{still[:5]}")
    evaluate = make_mae_eval_step(model, cfg)
    evals = [float(evaluate(state, batches[1])["loss"]) for _ in range(2)]
    log(f"  two evals at step {state.step}: {evals}")
    if evals[0] != evals[1] or not np.isfinite(evals[0]):
        raise AssertionError(f"evals at one state differ: {evals}")

    median = float(np.median(synced))
    result = dict(batch=PRETRAIN_BATCH, step_ms_median=median,
                  step_ms_min=float(np.min(synced)),
                  step_ms_pipelined=pipelined,
                  images_per_s=PRETRAIN_BATCH / median * 1e3,
                  images_per_s_pipelined=PRETRAIN_BATCH / pipelined * 1e3,
                  losses=total, eval_losses=evals, profile_5_steps=prof,
                  stages=step_stages(prof, 5), launches=launches,
                  peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"  step ms (each synchronised, median of 20) {median:.3f}, min "
        f"{result['step_ms_min']:.3f}; 20 steps back to back "
        f"{pipelined:.3f} ms per step; images/s {result['images_per_s']:.1f} "
        f"(back to back {result['images_per_s_pipelined']:.1f}); peak memory "
        f"{result['peak_memory_gb']:.2f} GB")
    log(f"  profiled 5 steps: {json.dumps(prof)}")
    log(f"  stages of one step (mean of the 5 profiled steps): "
        f"{json.dumps(result['stages'])}")
    return launches, result


# ---------------------------------------------------------------------------
# Phase 9: one pretrain step on the card against one on the CPU
# ---------------------------------------------------------------------------

def check_pretrain_step_against_cpu(rng: np.random.Generator) -> dict:
    """The MAE-pretrain step at full width, B=8, uint8 patches and the same
    weights and masks: the card in bf16 with the kernels, the CPU in fp32
    with the plain versions. Loss within 2e-2 relative; every gradient with
    cosine >= 0.99 to the CPU's."""
    from mae_clip_torch.models import mae_vit_for
    from mae_clip_torch.ops.masking import MaskingResult, random_masking
    from mae_clip_torch.train import (TrainState, make_mae_pretrain_step,
                                      make_optimizer)

    b = 8
    cfg, card = build_pretrain_model(b, "bfloat16", "cuda", seed=1)
    cpu_cfg = cfg.replace(compute_dtype="float32")
    cpu = mae_vit_for(cpu_cfg, device="cpu")
    cpu.patch_embed.masked_kernel = True
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    vcfg = card.config
    masking = random_masking(b, vcfg.num_patches, cfg.mae.mask_ratio,
                             torch.Generator().manual_seed(3))
    batch = {"image": torch.from_numpy(rng.integers(
                 0, 256, (b, vcfg.num_patches, vcfg.patch_size ** 2 * 3),
                 np.uint8)),
             "valid": torch.ones(b, dtype=torch.bool)}
    losses, grads = [], []
    for model, mcfg in ((card, cfg), (cpu, cpu_cfg)):
        opt = make_optimizer(mcfg, model)
        step = make_mae_pretrain_step(model, opt, mcfg)
        m = step(TrainState.create(model, opt, cfg=mcfg), batch,
                 masking=MaskingResult(*(x.to(model.device) for x in masking)))
        losses.append(float(m["loss"]))
        grads.append({n: p.grad.float().cpu()
                      for n, p in model.named_parameters()})
    log(f"  loss card bf16 {losses[0]} vs CPU fp32 {losses[1]}")
    if abs(losses[0] - losses[1]) > 2e-2 * abs(losses[1]):
        raise AssertionError(f"loss: card {losses[0]} vs CPU {losses[1]}")
    cos = {n: float(torch.nn.functional.cosine_similarity(
        g.flatten(), grads[1][n].flatten(), dim=0))
        for n, g in grads[0].items()}
    worst = sorted(cos.items(), key=lambda kv: kv[1])[:5]
    log(f"  gradient cosine card vs CPU over {len(cos)} tensors: lowest "
        f"{[(n, round(c, 5)) for n, c in worst]}")
    if worst[0][1] < 0.99:
        raise AssertionError(f"gradient cosine {worst[0]} < 0.99")
    return dict(losses=losses, min_grad_cosine=worst[0][1])


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Phases 16-17: the reference recipe (coco_full_config: ResNet-50 + frozen
# DistilBERT in train mode, AdamW) through the Trainer, on stores on the card
# ---------------------------------------------------------------------------

REF_BATCH = 256
REF_SEQ = 200        # coco_full_config's max_length
REF_TRAIN = (4096, 2048)   # rows, unique images (each caption's image twice)
REF_VALID = (1024, 512)
REF_DATA_SEED = 13
REF_RUN_SEED = 14
# The train step runs none of the seven kernels: the image tower is the
# ResNet (cuDNN) and the frozen text tower's train-mode attention drops out
# on the plain route. The eval step's text tower runs #2 once a layer.
REF_TRAIN_LAUNCHES = dict.fromkeys(LAUNCHES_PER_STEP, 0)
REF_EVAL_LAUNCHES = dict(REF_TRAIN_LAUNCHES, flash_attention=6)


def build_reference_model(batch: int, compute_dtype: str, device: str,
                          seed: int = 0, text_config=None,
                          resnet_shape=None, **cfg):
    """``coco_full_config`` (with ``cfg`` over it) as the port builds it:
    the ResNet-50 (or ``resnet_shape``), DistilBERT as ``text_config``
    (default: HF's, dropout 0.1), random weights from a CPU generator."""
    from mae_clip_torch import coco_full_config
    from mae_clip_torch.models import CLIPModel, DistilBertConfig

    cfg = coco_full_config(batch_size=batch, compute_dtype=compute_dtype,
                           **cfg)
    model = CLIPModel(cfg, text_config or DistilBertConfig(), device=device,
                      resnet_shape=resnet_shape)
    return model.init_weights(torch.Generator().manual_seed(seed))


def reference_stores(train=REF_TRAIN, valid=REF_VALID, size: int = 224,
                     seq: int = REF_SEQ, seed: int = REF_DATA_SEED,
                     device=None) -> tuple:
    """Train and valid ``DeviceStore``s made on the card from a seeded
    generator: uint8 images, each held once and mapped to two caption rows,
    and (rows, seq) token ids with 8-40 real tokens ([CLS] ... [SEP], then
    padding) and their masks."""
    from mae_clip_torch.data.device_store import DeviceStore

    device = DEVICE if device is None else device
    gen = torch.Generator(device=device).manual_seed(seed)
    stores = []
    for rows, images in (train, valid):
        img = torch.randint(0, 256, (images, size, size, 3), generator=gen,
                            device=device, dtype=torch.uint8)
        length = torch.randint(8, min(41, seq + 1), (rows,), generator=gen,
                               device=device)
        mask = (torch.arange(seq, device=device)[None] < length[:, None])
        ids = torch.randint(1000, 30000, (rows, seq), generator=gen,
                            device=device) * mask
        ids[:, 0] = 101
        ids[torch.arange(rows, device=device), length - 1] = 102
        stores.append(DeviceStore(
            {"image": img, "input_ids": ids, "attention_mask": mask.long()},
            maps={"image": torch.arange(rows, device=device)
                  // (rows // images)}, device=device))
    return tuple(stores)


def _loader_fns(train_rows: int, valid_rows: int, batch: int):
    from mae_clip_torch.data.device_store import make_index_loader

    return (lambda epoch: make_index_loader(train_rows, batch, True,
                                            seed=epoch),
            lambda epoch: make_index_loader(valid_rows, batch))


def _buffers(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def train_reference_recipe() -> tuple:
    """Phase 16 (a) and (b). (a) the bare step of ``coco_full_config`` at
    batch 256 on batches gathered from the train store: 3 warm-up steps,
    then ms a step (20 synchronised, 20 back to back), 5 profiled steps,
    peak memory, the kernels' launches in the train and the eval step, the
    running statistics moved. (b) ``Trainer.fit`` for 2 epochs of 16 train
    and 4 valid steps with epoch and step checkpoints and the metric writer
    in a temporary directory, then a new Trainer's ``restore`` of the last
    epoch. Returns (launches by path, result, model, stores, initial
    weights)."""
    import shutil
    import tempfile

    from mae_clip_torch.data.device_store import make_index_loader
    from mae_clip_torch.train import (CheckpointManager, MetricWriter,
                                      StepCheckpointManager, Trainer,
                                      TrainState, make_eval_step,
                                      make_optimizer, make_train_step)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_reference_model(REF_BATCH, "bfloat16", "cuda")
    initial = {k: v.detach().clone() for k, v in model.state_dict().items()}
    train_store, valid_store = reference_stores()
    setup_s = time.perf_counter() - t0
    cfg, dev = model.cfg, model.device
    log(f"  model and stores in {setup_s:.1f} s: train store "
        f"{train_store.nbytes / 1e6:.1f} MB ({train_store.n} rows), valid "
        f"{valid_store.nbytes / 1e6:.1f} MB ({valid_store.n} rows)")

    def gathered(store, rows, seed):
        out = []
        for b in list(make_index_loader(rows, REF_BATCH, True, seed))[:2]:
            batch = store.gather(b["indices"])
            batch["valid"] = torch.from_numpy(b["valid"]).to(dev)
            out.append(batch)
        return out

    batches = gathered(train_store, REF_TRAIN[0], 0)
    valid_batches = gathered(valid_store, REF_VALID[0], 0)
    opt = make_optimizer(cfg, model)
    state = TrainState.create(model, opt, seed=cfg.seed)
    step, eval_step = make_train_step(model, opt, cfg), make_eval_step(model,
                                                                       cfg)
    stats0 = _buffers(model)
    steps = 0

    def run(batch):
        nonlocal steps
        steps += 1
        return step(state, batch)

    counts = _reset_counts()
    losses = [float(run(batches[i % 2])["loss"]) for i in range(3)]
    synced = [_synced_ms(lambda i=i: run(batches[i % 2])) for i in range(20)]
    pipelined = _synced_ms(lambda: [run(batches[i % 2])
                                    for i in range(20)]) / 20
    prof = profile_window(lambda: [run(batches[i % 2]) for i in range(5)],
                          top=10, spans=STEP_SPANS,
                          check=lambda window: step_stages(window, 5))
    train_launches = _read_counts(counts)
    losses.append(float(run(batches[0])["loss"]))
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite losses {losses}")
    for name, n in REF_TRAIN_LAUNCHES.items():
        if train_launches[name] != n * steps:
            raise AssertionError(f"train step: {name} launched "
                                 f"{train_launches[name]} times in {steps}")
    moved = {k: float((v - stats0[k]).abs().max())
             for k, v in _buffers(model).items()}
    if not all(m > 0 for m in moved.values()):
        raise AssertionError("running statistics that did not move: "
                             f"{[k for k, m in moved.items() if m == 0]}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    counts = _reset_counts()
    eval_ms = [_synced_ms(lambda i=i: eval_step(state, valid_batches[i % 2]))
               for i in range(4)]
    eval_launches = _read_counts(counts)
    for name, n in REF_EVAL_LAUNCHES.items():
        if eval_launches[name] != n * 4:
            raise AssertionError(f"eval step: {name} launched "
                                 f"{eval_launches[name]} times in 4")
    median = float(np.median(synced))
    stages = step_stages(prof, 5)
    bare = dict(batch=REF_BATCH, steps=steps, step_ms_median=median,
                step_ms_min=float(np.min(synced)),
                step_ms_pipelined=pipelined,
                pairs_per_s=REF_BATCH / median * 1e3,
                pairs_per_s_pipelined=REF_BATCH / pipelined * 1e3,
                busy_share=prof["busy_share"],
                device_ms_per_step=prof["device_busy_ms"] / 5,
                stages=stages, peak_memory_gb=peak,
                eval_step_ms_median=float(np.median(eval_ms)),
                losses=losses, bn_buffers_moved=len(moved),
                profile_5_steps=prof)
    log(f"  (a) step ms (each synchronised, median of 20) {median:.3f}, min "
        f"{bare['step_ms_min']:.3f}; 20 back to back {pipelined:.3f} ms a "
        f"step; pairs/s {bare['pairs_per_s']:.1f}; device "
        f"{bare['device_ms_per_step']:.3f} ms a step, busy "
        f"{prof['busy_share']:.3f}; peak {peak:.2f} GB; eval step "
        f"{bare['eval_step_ms_median']:.3f} ms; losses {losses}")
    log(f"  (a) stages {json.dumps(stages)}")
    log(f"  (a) launches: train step {train_launches}; eval step "
        f"{eval_launches}; {len(moved)} BatchNorm buffers moved")
    log(f"  (a) profiled 5 steps: {json.dumps(prof)}")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ref_")
    try:
        fit_cfg = cfg.replace(epochs=2, checkpoint_every=1,
                              checkpoint_every_steps=4,
                              metric_fetch_every=16)
        writer = MetricWriter(f"{tmp}/logs")
        trainer = Trainer(fit_cfg, model,
                          checkpoint_manager=CheckpointManager(f"{tmp}/ep"),
                          step_checkpoint_manager=StepCheckpointManager(
                              f"{tmp}/steps"),
                          writer=writer, train_store=train_store,
                          valid_store=valid_store)
        t0 = time.perf_counter()
        history = trainer.fit(*_loader_fns(REF_TRAIN[0], REF_VALID[0],
                                           REF_BATCH))
        fit_s = time.perf_counter() - t0
        writer.close()
        with open(f"{tmp}/logs/metrics.jsonl") as f:
            records = [json.loads(line) for line in f]
        if trainer.state.step != 32 or len(records) != 2 or not np.isfinite(
                history["train_loss"] + history["valid_loss"]).all():
            raise AssertionError(f"fit: {trainer.state.step} steps, "
                                 f"history {history}")
        kept = {"epochs": trainer.checkpoint_manager.all_steps(),
                "steps": trainer.step_checkpoint_manager.all_steps()}
        if kept != {"epochs": [0, 1], "steps": [28, 32]} and kept != {
                "epochs": [1], "steps": [28, 32]}:
            raise AssertionError(f"checkpoints kept: {kept}")
        t0 = time.perf_counter()
        trainer.step_checkpoint_manager.save(10 ** 6, trainer.state, {})
        save_s = time.perf_counter() - t0
        ckpt_bytes = os.path.getsize(f"{tmp}/steps/{10 ** 6}.pt")
        live = {k: v.clone() for k, v in model.state_dict().items()}
        other = Trainer(fit_cfg, model,
                        checkpoint_manager=CheckpointManager(f"{tmp}/ep"))
        t0 = time.perf_counter()
        epoch = other.restore()
        restore_s = time.perf_counter() - t0
        if epoch != 1 or other.state.step != 32 or not all(
                torch.equal(v, live[k])
                for k, v in model.state_dict().items()):
            raise AssertionError("the last epoch's checkpoint does not "
                                 "restore the trained state")
    finally:
        shutil.rmtree(tmp)
    train_s = [r["time/train_s"] for r in records]
    steps_s, saves_s = 16 * median / 1e3, 4 * save_s
    fit = dict(history=history, records=records, fit_s=fit_s,
               checkpoints_kept=kept, checkpoint_bytes=ckpt_bytes,
               checkpoint_save_s=save_s, restore_s=restore_s,
               epoch_train_s=train_s, steps_16_s=steps_s,
               rest_share=[1 - steps_s / s for s in train_s],
               trainer_share=[1 - (steps_s + saves_s) / s for s in train_s])
    log(f"  (b) history {json.dumps(history)}")
    for r in records:
        log(f"  (b) metrics.jsonl {json.dumps(r)}")
    log(f"  (b) fit {fit_s:.2f} s; time/train_s {train_s} against 16 bare "
        f"steps {steps_s:.3f} s: the rest (4 step checkpoints and the "
        f"Trainer) {[round(x, 4) for x in fit['rest_share']]} of each "
        f"epoch, less 4 saves timed alone "
        f"{[round(x, 4) for x in fit['trainer_share']]}; a checkpoint "
        f"{ckpt_bytes / 1e6:.1f} MB, saved in {save_s:.3f} s, an epoch "
        f"restored in {restore_s:.3f} s")
    result = dict(setup_s=setup_s, bare_step=bare, fit=fit)
    launches = {"training_reference": train_launches,
                "eval_reference": eval_launches}
    return launches, result, model, (train_store, valid_store), initial


def check_mid_epoch_resume(batch: int = REF_BATCH, size: int = 224,
                           train_batches: int = 16, stop_after: int = 8,
                           valid_batches: int = 4, resnet_shape=None,
                           directory: Optional[str] = None, model=None,
                           initial: Optional[dict] = None,
                           stores: Optional[tuple] = None) -> dict:
    """Phase 16 (c): with deterministic cuDNN (restored after), two epochs
    of ``Trainer.fit`` uninterrupted, then a run stopped after
    ``stop_after`` batches of epoch 0 (a step checkpoint there) and a new
    Trainer's ``restore_mid_epoch`` finishing it. The resumed run's
    parameters, BatchNorm buffers and valid losses (and epoch 1's train
    loss) must equal the uninterrupted run's bit for bit. Builds the model
    and the stores when not given."""
    import itertools
    import shutil
    import tempfile

    from mae_clip_torch.train import StepCheckpointManager, Trainer

    if model is None:
        model = build_reference_model(batch, "bfloat16", "cuda",
                                      resnet_shape=resnet_shape, size=size)
        initial = {k: v.detach().clone()
                   for k, v in model.state_dict().items()}
    if stores is None:
        stores = reference_stores((batch * train_batches,
                                   batch * train_batches // 2),
                                  (batch * valid_batches,
                                   batch * valid_batches // 2), size=size)
    cfg = model.cfg.replace(batch_size=batch, epochs=2, checkpoint_every=0,
                            checkpoint_every_steps=stop_after,
                            metric_fetch_every=16)
    train_fn, valid_fn = _loader_fns(batch * train_batches,
                                     batch * valid_batches, batch)
    own = directory is None
    directory = tempfile.mkdtemp(prefix="chip_smoke_resume_") if own \
        else directory
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False

    def trainer(path):
        return Trainer(cfg, model, step_checkpoint_manager=(
            StepCheckpointManager(path)), train_store=stores[0],
            valid_store=stores[1])

    try:
        model.load_state_dict(initial)
        torch.manual_seed(REF_RUN_SEED)
        t0 = time.perf_counter()
        want = trainer(f"{directory}/a").fit(train_fn, valid_fn)
        straight_s = time.perf_counter() - t0
        final = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(initial)
        torch.manual_seed(REF_RUN_SEED)
        trainer(f"{directory}/b").train_epoch(
            itertools.islice(train_fn(0), stop_after))
        torch.manual_seed(REF_RUN_SEED + 1)     # a new process's RNG
        model.load_state_dict(initial)
        resumed = trainer(f"{directory}/b")
        epoch, done = resumed.restore_mid_epoch()
        if (epoch, done, resumed.state.step) != (0, stop_after, stop_after):
            raise AssertionError(f"restored at {(epoch, done)}, step "
                                 f"{resumed.state.step}")
        got = resumed.fit(train_fn, valid_fn, start_epoch=epoch,
                          skip_batches=done)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = flags
        if own:
            shutil.rmtree(directory)
    diff = {k: float((v.float() - final[k].float()).abs().max())
            for k, v in model.state_dict().items()
            if not torch.equal(v, final[k])}
    same_losses = (got["valid_loss"] == want["valid_loss"]
                   and got["train_loss"][1:] == want["train_loss"][1:])
    log(f"  (c) uninterrupted {json.dumps(want)} in {straight_s:.2f} s; "
        f"resumed after {stop_after} batches {json.dumps(got)}; tensors "
        f"that differ: {len(diff)} of {len(final)}")
    if diff or not same_losses:
        raise AssertionError(f"the resumed run is not bit-identical: "
                             f"losses {got} vs {want}, tensors "
                             f"{dict(list(diff.items())[:8])}")
    return dict(uninterrupted=want, resumed=got, tensors=len(final),
                bn_buffers=sum(k.endswith("running_var") for k in final),
                straight_s=straight_s, bit_identical=True)


def _reference_batch(rng: np.random.Generator, batch: int, size: int
                     ) -> dict:
    return {"image": torch.from_numpy(rng.integers(
                0, 256, (batch, size, size, 3), np.uint8)),
            "input_ids": torch.from_numpy(rng.integers(
                1000, 30000, (batch, TRAIN_SEQ))),
            "attention_mask": _padding_mask(
                torch.Generator().manual_seed(5), batch, TRAIN_SEQ,
                "cpu").long(),
            "valid": torch.ones(batch, dtype=torch.bool)}


def _step_against_cpu(data: dict, resnet_shape,
                      compute_dtype: str = "bfloat16",
                      device: str = "cuda") -> dict:
    """One reference-recipe step on ``data`` at dropout 0 on ``device``
    (the card: in ``compute_dtype``, cuDNN, the kernels) and on the CPU
    (fp32, plain versions) from the same weights: the metrics' relative
    error, every trainable gradient's cosine (those 0 in exact arithmetic
    held by size, as phase 7), and each BatchNorm buffer's change
    ``||d_card - d_cpu|| / ||d_cpu||``. Which limits hold is the caller's
    to decide."""
    from mae_clip_torch.models import CLIPModel, DistilBertConfig
    from mae_clip_torch.train import (TrainState, make_optimizer,
                                      make_train_step)

    batch, size = data["image"].shape[:2]
    text_config = DistilBertConfig(dropout=0.0, attention_dropout=0.0)
    card = build_reference_model(batch, compute_dtype, device, seed=1,
                                 text_config=text_config,
                                 resnet_shape=resnet_shape, dropout=0.0,
                                 size=size)
    cpu = CLIPModel(card.cfg.replace(compute_dtype="float32"),
                    card.text_config, device="cpu",
                    resnet_shape=card.resnet_shape)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    stats0 = {k: v.cpu() for k, v in _buffers(card).items()}
    metrics, grads, deltas = [], [], []
    for model in (card, cpu):
        opt = make_optimizer(model.cfg, model)
        m = make_train_step(model, opt, model.cfg)(
            TrainState.create(model, opt), data)
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append({n: p.grad.float().cpu()
                      for n, p in model.named_parameters() if p.requires_grad})
        deltas.append({k: v.cpu() - stats0[k]
                       for k, v in _buffers(model).items()})
    loss_err = max(abs(metrics[0][k] - v) / abs(v)
                   for k, v in metrics[1].items())
    big = max(float(g.norm()) for g in grads[1].values())
    zero = {n for n, g in grads[1].items() if float(g.norm()) <= 1e-6 * big}
    stray = max([float(grads[0][n].norm()) / big for n in zero] or [0.0])
    cos = {n: float(torch.nn.functional.cosine_similarity(
        g.flatten(), grads[1][n].flatten(), dim=0))
        for n, g in grads[0].items() if n not in zero}
    stat_err = {k: float((d - deltas[1][k]).norm() / deltas[1][k].norm())
                for k, d in deltas[0].items()}
    worst_cos = sorted(cos.items(), key=lambda kv: kv[1])[:5]
    worst_stat = sorted(stat_err.items(), key=lambda kv: -kv[1])[:5]
    reading = dict(
        resnet_shape=resnet_shape or "resnet50", batch=batch, size=size,
        compute_dtype=compute_dtype, device=device, metrics=metrics, loss_rel_err=loss_err,
        min_grad_cosine=worst_cos[0][1], lowest_grad_cosines=worst_cos,
        exact_zero_grads=len(zero), exact_zero_grad_share=stray,
        max_stat_change_err=worst_stat[0][1], worst_stat_changes=worst_stat,
        grads=len(cos), bn_buffers=len(stat_err))
    log(f"  {reading['resnet_shape']} at B={batch}, {size}^2, "
        f"{compute_dtype} on {device}: metrics {metrics[0]} vs CPU fp32 "
        f"{metrics[1]} "
        f"(rel err {loss_err:.3g}); lowest gradient cosines {worst_cos} "
        f"({len(zero)} exact-zero gradients at {stray:.3g} of the "
        f"largest); largest running-statistics change errors {worst_stat}")
    return reading


SHALLOW_RESNET = ((1, 1, 1, 1), (64, 128, 256, 512))
# The card's bf16 step may fall below the CPU's own bf16 step (both held
# against the CPU's fp32 step on the same batch) by at most this much in
# its lowest gradient cosine: the two round in other orders (cuDNN's and
# the CPU's convolutions and sums), and at one bottleneck a stage both
# read ~0.92.
BF16_GRAD_MARGIN = 0.05


def _limits(reading: dict, grads: bool) -> list:
    """Phase 7's limits a reading misses: the metrics within 2e-2
    relative, the running statistics' change within 2e-2 of its size and,
    with ``grads``, every gradient cosine >= 0.99 (exact-zero gradients
    below 1e-3 of the largest)."""
    missed = []
    if reading["loss_rel_err"] > 2e-2:
        missed.append("metrics")
    if reading["max_stat_change_err"] > 2e-2:
        missed.append("running statistics")
    if grads and (reading["min_grad_cosine"] < 0.99
                  or reading["exact_zero_grad_share"] > 1e-3):
        missed.append("gradient cosines")
    return missed


def check_resnet_step_against_cpu(rng: np.random.Generator, batch: int = 8,
                                  size: int = 224,
                                  resnet_shape=None,
                                  shallow=SHALLOW_RESNET) -> dict:
    """Phase 17 (a): one reference-recipe step, the card against the CPU's
    fp32 step, at phase 7's limits (``_limits``).

    In bf16 the gradients of a train-mode BatchNorm tower at random
    weights are not held to the cosine limit: the bf16 forward drifts by
    ~1 % a stage (0.3 % after the stem, 4.3 % after stage 4, measured on
    the CPU in bf16) and every train-mode BatchNorm renormalises the drift,
    and the pooled features of noise images are nearly parallel (cosine
    ~0.95), so the contrastive gradient is a small rest: the CPU's own bf16
    step, with no card and no kernel, gives gradient cosines of 0.08 at
    full depth and 0.925 with one bottleneck a stage. So the bf16 readings
    (full depth, then ``shallow``) are recorded with what they miss; the
    shallow one must hold the metrics' and the statistics' limits, and its
    lowest gradient cosine must be within ``BF16_GRAD_MARGIN`` of the CPU's
    own bf16 step on the same batch (which holds the card's bf16
    backward: cuDNN's convolutions and the BatchNorms). The card's
    fp32 step (TF32 off, the same cuDNN and BatchNorm path) at the full
    depth must hold all of phase 7's limits, the gradient cosines
    included."""
    data = _reference_batch(rng, batch, size)
    bf16 = [_step_against_cpu(data, resnet_shape)]
    if _limits(bf16[0], True):
        bf16.append(_step_against_cpu(data, shallow))
    cpu_bf16 = _step_against_cpu(data, resnet_shape if len(bf16) == 1
                                 else shallow, device="cpu")
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        fp32 = _step_against_cpu(data, resnet_shape, "float32")
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    for r in bf16 + [cpu_bf16, fp32]:
        r["misses"] = _limits(r, True)
    floor = cpu_bf16["min_grad_cosine"] - BF16_GRAD_MARGIN
    bf16_misses = _limits(bf16[-1], False)
    if bf16[-1]["min_grad_cosine"] < floor:
        bf16_misses.append(f"lowest gradient cosine below the CPU's bf16 "
                           f"step's less {BF16_GRAD_MARGIN} ({floor:.4f})")
    log(f"  bf16 readings miss {[r['misses'] for r in bf16]}; the CPU's own "
        f"bf16 step's lowest gradient cosine "
        f"{cpu_bf16['min_grad_cosine']:.4f}, the card's "
        f"{bf16[-1]['min_grad_cosine']:.4f} (at least {floor:.4f}); the "
        f"fp32 step misses {fp32['misses']}")
    if bf16_misses or fp32["misses"]:
        raise AssertionError(f"card vs CPU reference-recipe step: bf16 "
                             f"misses {bf16_misses}: {bf16[-1]}, CPU bf16 "
                             f"{cpu_bf16}, fp32 {fp32}")
    return dict(bf16=bf16, cpu_bf16=cpu_bf16, fp32=fp32)


def check_resnet_serving_against_cpu(model, rng: np.random.Generator) -> dict:
    """Phase 17 (b): a trained ResNet CLIP (running statistics moved by its
    steps) served through ``RetrievalService``: gallery and query
    embeddings on the card against the CPU's fp32 model, row cosine >=
    0.99, and a query answered from the card's gallery."""
    from mae_clip_torch.data.tokenizer import WordPieceTokenizer, build_vocab
    from mae_clip_torch.models import CLIPModel
    from mae_clip_torch.serve import RetrievalService

    model.eval()
    cpu = CLIPModel(model.cfg.replace(compute_dtype="float32"),
                    model.text_config, device="cpu",
                    resnet_shape=model.resnet_shape)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    tok = WordPieceTokenizer(build_vocab(CORPUS * 4, vocab_size=256))
    size = model.cfg.size
    images = rng.integers(0, 256, (16, size, size, 3), np.uint8)
    card_svc = RetrievalService(model, tok, max_length=FIXED_LENGTH)
    cpu_svc = RetrievalService(cpu, tok, max_length=FIXED_LENGTH)
    worst = {}
    for what, fn in (("gallery", lambda s: s.embed_images(images)),
                     ("queries", lambda s: s.embed_text(CORPUS))):
        a, b = torch.from_numpy(fn(card_svc)), torch.from_numpy(fn(cpu_svc))
        worst[what] = float(torch.nn.functional.cosine_similarity(
            a, b, dim=-1).min())
    gallery = card_svc.embed_images(images)
    served = RetrievalService(model, tok, gallery=gallery,
                              max_length=FIXED_LENGTH).retrieve(CORPUS[0], 4)
    log(f"  (b) lowest row cosine card bf16 vs CPU fp32: {worst}; retrieve "
        f"{served}")
    if min(worst.values()) < 0.99 or len(served["matches"]) != 4:
        raise AssertionError(f"ResNet serving card vs CPU: {worst}, "
                             f"{served}")
    return worst


KERNELS = {  # name: (TPU kernel it replaces, source)
    "qkv_packed_attention": ("mae_clip_tpu/ops/attention.py:303",
                             "mae_clip_torch/csrc/attention_fwd.cu"),
    "flash_attention": ("mae_clip_tpu/ops/attention.py:76",
                        "mae_clip_torch/csrc/attention_fwd.cu"),
    "qkv_packed_attention_bwd": ("mae_clip_tpu/ops/attention.py:324",
                                 "mae_clip_torch/csrc/attention_bwd.cu"),
    "flash_attention_bwd": ("mae_clip_tpu/ops/attention.py:172",
                            "mae_clip_torch/csrc/attention_bwd.cu"),
    "masked_patch_embed": ("mae_clip_tpu/ops/patch_embed.py:40",
                           "mae_clip_torch/csrc/patch_embed.cu"),
    "fused_block_stack": ("mae_clip_tpu/ops/block_kernel.py:169",
                          "mae_clip_torch/csrc/block_stack_fwd.cu"),
    "fused_block_stack_bwd": ("mae_clip_tpu/ops/block_kernel.py:204",
                              "mae_clip_torch/csrc/block_stack_bwd.cu"),
}


def _counters():
    from mae_clip_torch.ops import attention as A
    from mae_clip_torch.ops import block_kernel as BK
    from mae_clip_torch.ops import patch_embed as PE

    return {"fused_block_stack": (BK.fused_block_stack, "launches"),
            "fused_block_stack_bwd": (BK.fused_block_stack, "bwd_launches"),
            # Not a launch: the state buffers #6's wrapper allocates.
            "fused_block_stack_state": (BK.fused_block_stack,
                                        "state_allocs"),
            "qkv_packed_attention": (A.qkv_packed_attention, "launches"),
            "flash_attention": (A.flash_attention, "launches"),
            "qkv_packed_attention_bwd": (A.qkv_packed_attention,
                                         "bwd_launches"),
            "flash_attention_bwd": (A.flash_attention, "bwd_launches"),
            "masked_patch_embed": (PE.masked_patch_embed, "launches")}


def _reset_counts() -> dict:
    counters = _counters()
    for fn, field in counters.values():
        setattr(fn, field, 0)
    return counters


def _read_counts(counters: dict) -> dict:
    return {name: getattr(fn, field) for name, (fn, field) in counters.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    log(f"card: {card_line()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log("phase 1: build")
    build_kernels()
    log("phase 2: kernels vs plain versions (forward, backward, masked "
        "patch embedding, the block stacks' GEMM body per template, block "
        "stacks), augmentation card vs CPU")
    errs = check_kernels()
    check_backward_kernels(errs)
    check_large_batch_attention(errs)
    check_patch_embed_kernel(errs)
    check_gemm_bodies(errs)
    check_block_stack_kernels(errs)
    check_augment_on_card()

    log("phase 3: flagship serving path (ViT-S/16 + DistilBERT, bf16)")
    rng = np.random.default_rng(0)
    model = build_flagship("cuda", "bfloat16")
    counts = _reset_counts()
    e2e = serve_flagship(model, rng)
    served = _read_counts(counts)
    log(f"  kernel launches on the serving path: {served}")
    for name in ("qkv_packed_attention", "flash_attention"):
        if served[name] == 0:
            raise AssertionError(f"{name} never launched on the serving path")

    log("phase 4: card vs CPU embeddings")
    check_against_cpu(model, rng)
    del model

    log("phase 6: flagship training step (B=256, bf16, cached text)")
    launches, train = train_flagship()
    log("phase 7: card vs CPU training step (B=8, full width)")
    train["against_cpu"] = check_train_step_against_cpu(rng)
    log("phase 8: MAE-pretrain step (B=256, bf16, in-step crops, MAE-paper "
        "decoder, masked patch-embed kernel)")
    pre_launches, pretrain = pretrain_mae(rng)
    log("phase 9: card vs CPU pretrain step (B=8, full width)")
    pretrain["against_cpu"] = check_pretrain_step_against_cpu(rng)
    log("phase 10: the flagship training step with fused_blocks='on' (#6 "
        "and #7), then 'fwd' (#6, per-block plain backward); B=256, bf16")
    fused_launches, fused = train_flagship("on", FUSED_LAUNCHES_PER_STEP["on"])
    fwd_launches, fused_fwd = train_flagship("fwd",
                                             FUSED_LAUNCHES_PER_STEP["fwd"])
    log("phase 11: card vs CPU fused training step (B=8, full width), and "
        "the fused serving tower against per block")
    fused["against_cpu"] = check_train_step_against_cpu(rng, "on")
    fused["encode_full_min_cosine"] = check_fused_serving_tower(rng)
    state_gb = sum(_stack_work(s, 2)[4] for s in STACK_SHAPES.values()) / 1e9
    log(f"  fused_blocks='on' step: peak memory {fused['peak_memory_gb']:.3f} "
        f"GB, of which the two stacks' state ~{state_gb:.3f} GB ('fwd' "
        f"{fused_fwd['peak_memory_gb']:.3f}, per block "
        f"{train['peak_memory_gb']:.3f}); lowest gradient cosine card vs CPU "
        f"{fused['against_cpu']['min_grad_cosine']:.5f} (limit 0.99)")

    log("phase 12: flagship_siglip_config's training step (B=256, bf16, "
        "per block), as the preset is, then with LAMB, cosine, clipping "
        "and EMA")
    t_phase = time.perf_counter()
    siglip_launches, siglip = train_siglip()
    log(f"  phase 12 took {time.perf_counter() - t_phase:.1f} s")
    log("phase 13: card vs CPU with the other training options (B=8, full "
        "width): SigLIP, hard labels + learnable temperature, LAMB + cosine "
        "+ clip + EMA, a trained text tower; attention dropout on the card")
    t_phase = time.perf_counter()
    siglip["against_cpu"] = check_siglip_options_against_cpu(rng)
    log(f"  phase 13 took {time.perf_counter() - t_phase:.1f} s")
    log("phase 14: large_batch_mesh_config's step at batch 32,768 (bf16, "
        "GradCache over 8 microbatches, the chunked loss, LAMB, remat, the "
        "MAE-paper decoder)")
    t_phase = time.perf_counter()
    large_launches, large = train_large_batch()
    log(f"  phase 14 took {time.perf_counter() - t_phase:.1f} s")
    log("phase 15: the slice's checks on the card: chunked losses, "
        "GradCache against one pass, the card's GradCache step against the "
        "CPU's one pass")
    t_phase = time.perf_counter()
    large["checks"] = check_large_batch_options(rng)
    log(f"  phase 15 took {time.perf_counter() - t_phase:.1f} s")
    log("phase 16: the reference recipe on one card (coco_full_config: "
        "ResNet-50 with train-mode BatchNorm, frozen DistilBERT in train "
        "mode, AdamW, B=256, bf16) from stores on the card: (a) the bare "
        "step, (b) Trainer.fit with checkpoints, (c) a mid-epoch resume")
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    ref_launches, ref, ref_model, ref_stores, ref_initial = \
        train_reference_recipe()
    ref["resume"] = check_mid_epoch_resume(model=ref_model,
                                           initial=ref_initial,
                                           stores=ref_stores)
    del ref_initial, ref_stores
    log(f"  phase 16 took {time.perf_counter() - t_phase:.1f} s")
    log("phase 17: the reference recipe against the CPU: (a) one step at "
        "B=8, (b) serving a trained ResNet CLIP")
    t_phase = time.perf_counter()
    ref["against_cpu"] = check_resnet_step_against_cpu(rng)
    ref["serving_min_cosine"] = check_resnet_serving_against_cpu(ref_model,
                                                                 rng)
    del ref_model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 17 took {time.perf_counter() - t_phase:.1f} s")

    log("phase 5: kernel times (serving, training, pretraining shapes, the "
        "block stacks' GEMM products, then "
        "the block stacks)")
    time_serving_kernels()
    times = time_training_kernels()
    pre_times = time_pretrain_kernels()
    wide_times = time_wide_heads()
    large_times = time_large_batch_kernels()
    gemm_times = time_gemm_shapes()
    stack_times = time_block_stacks()
    log(f"end to end: serving {json.dumps(e2e)}")
    log(f"end to end: training {json.dumps(train)}")
    log(f"end to end: pretraining {json.dumps(pretrain)}")
    log(f"end to end: training, fused_blocks='on' {json.dumps(fused)}")
    log(f"end to end: training, fused_blocks='fwd' {json.dumps(fused_fwd)}")
    log(f"end to end: training, SigLIP {json.dumps(siglip)}")
    summary = {k: v for k, v in large.items() if k != "profile_2_steps"}
    log(f"end to end: training, large_batch_mesh_config "
        f"{json.dumps(summary)}")
    summary = dict(ref, bare_step={k: v for k, v in ref["bare_step"].items()
                                   if k != "profile_5_steps"})
    log(f"end to end: the reference recipe, coco_full_config "
        f"{json.dumps(summary)}")
    log(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")

    by_path = {"serving": served, "training": launches,
               "pretraining": pre_launches, "training_fused": fused_launches,
               "training_fused_fwd": fwd_launches,
               "training_siglip": siglip_launches,
               "training_large_batch": large_launches, **ref_launches}
    kernels = []
    for name, (replaces, source) in KERNELS.items():
        extra = {}
        if name in stack_times:
            t = stack_times[name]["encoder"]
            extra["decoder_shape"] = {
                k: stack_times[name]["decoder"][k]
                for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                          "design_bound_ms", "library_ms", "with_state",
                          "launch_breakdown")
                if k in stack_times[name]["decoder"]}
            extra["library"] = t["library"]
            extra["launch_breakdown"] = t["launch_breakdown"]
            extra["gemm_body_max_err_of_limit"] = errs["gemm_body"]
            extra["gemm_shapes"] = {
                which: [r for r in rows if r["kernel"] == name]
                for which, rows in gemm_times.items()}
            if "with_state" in t:
                extra["with_state"] = t["with_state"]
        else:
            t = times[name] if name in times else pre_times[name]
        if name in times and name in pre_times:
            extra["pretrain_shape"] = {
                k: pre_times[name][k] for k in ("shape", "ms", "plain_ms",
                                                "bound_ms", "design_bound_ms",
                                                "library_ms")
                if k in pre_times[name]}
        if "design_bound_ms" in t:
            extra["design_bound_ms"] = t["design_bound_ms"]
        if name == "flash_attention":
            extra["ms_without_lse"] = times["flash_attention_no_lse"]["ms"]
        if name == "masked_patch_embed":
            extra.update({k: t[k] for k in ("bound_share", "cast_ms",
                                            "cast_bound_ms",
                                            "cast_and_kernel_ms")})
        if name in large_times:
            extra["large_batch_shape"] = {
                k: large_times[name][k] for k in ("shape", "ms", "plain_ms",
                                                  "bound_ms", "bound_by",
                                                  "library_ms")}
        if name in wide_times:
            extra["head_dim_256"] = {
                k: wide_times[name][k] for k in ("shape", "ms", "plain_ms",
                                                 "bound_ms", "library_ms")}
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(c[name] for c in by_path.values()),
            launches_by_path={k: c[name] for k, c in by_path.items()},
            max_abs_err=errs[name], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], shape=t["shape"], **extra))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
