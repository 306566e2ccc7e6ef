#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``mae_clip_torch/csrc``, holds each
against its plain PyTorch version on the card, serves the flagship model
(ViT-S/16 + DistilBERT, random seeded weights, bf16) over HTTP through the
port's entry points, checks what comes back, checks the card's embeddings
against the CPU's plain path, and times each kernel beside its bound. Any
failed check raises, so the run exits non-zero. The last line of standard
output is ``{"ok": true, "device": {...}}``; before it come the
``{"kernels": [...]}`` summary and the card's name and power limit.

It imports nothing of JAX and nothing of the JAX package. It exits non-zero,
printing no result, when no CUDA card is present.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM rate, dense bf16 tensor rate, and
# fp32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

FP32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_ATOL = 2e-2


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
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
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {src}: {line.strip()}")
    _build.load_attention()


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

    def run(name, fn, ref, inputs):
        for dt in (torch.float32, torch.bfloat16):
            xs = [x.to(dt) if x is not None and x.is_floating_point()
                  and x.dim() > 2 else x for x in inputs]
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
    # B=64, and a masked case at S=50 (the masked encoder pass's length).
    for b, s, h, masked in ((64, 197, 3, False), (8, 50, 3, True)):
        qkv = torch.randn(b, s, 3 * h * 128, generator=gen).to(dev)
        kv = _padding_mask(gen, b, s, dev) if masked else None
        run("qkv_packed_attention",
            lambda x, m, h=h: A.qkv_packed_attention(x, m, h),
            lambda x, m, h=h: A.qkv_packed_attention_ref(x, m, h),
            [qkv, kv])

    # Flash: DistilBERT at serving (B=16, 6 heads of 128, S=64, padding
    # mask) with the head split as a strided view of a linear output, the
    # CrossMAE decoder's cross-attention (Sq=147, Sk=50, 2x128), and S=300
    # for several key tiles.
    def flash_case(b, h, sq, sk, masked, strided, d=128):
        if strided:  # (B, S, H, Dh) storage seen as (B, H, S, Dh)
            q, k, v = (torch.randn(b, n, h, d, generator=gen).to(dev)
                       .transpose(1, 2) for n in (sq, sk, sk))
        else:
            q, k, v = (torch.randn(b, h, n, d, generator=gen).to(dev)
                       for n in (sq, sk, sk))
        kv = _padding_mask(gen, b, sk, dev) if masked else None
        run("flash_attention", A.flash_attention, A.flash_attention_ref,
            [q, k, v, kv])

    flash_case(16, 6, 64, 64, True, True)
    flash_case(16, 6, 64, 64, True, False)
    flash_case(8, 2, 147, 50, False, False)
    flash_case(2, 2, 300, 300, True, False)
    # Other head dims: 64 (tensor-core body) and 80 (the scalar body, which
    # also serves fp32 and unaligned strides).
    flash_case(4, 2, 77, 77, True, False, d=64)
    flash_case(2, 3, 33, 40, True, False, d=80)
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


def _device_ms(fn, iters: int = 50) -> float:
    """Device time per call: the summed durations of every CUDA kernel (and
    copy) that ``iters`` calls run, from a torch.profiler trace, over iters.
    Host dispatch between launches is not counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.device_time_total for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if total_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    return total_us / 1e3 / iters


def _bound_ms(bytes_moved: float, flops: float, dtype) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels() -> dict:
    """Kernel, plain-version and library times at the serving shapes."""
    import torch.nn.functional as F

    from mae_clip_torch.ops import attention as A

    dev, dt = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(1)
    out = {}
    saved = (A.qkv_packed_attention.launches, A.flash_attention.launches)

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
    A.qkv_packed_attention.launches, A.flash_attention.launches = saved
    for name, r in out.items():
        log(f"  {name} [{r['shape']}]: device ms per call: kernel "
            f"{r['ms']:.4f}, bound {r['bound_ms']:.4f} ({r['bound_by']}), "
            f"plain {r['plain_ms']:.4f}, sdpa {r['library_ms']:.4f}; wall "
            f"ms per call with host dispatch: kernel {r['call_ms']:.4f}, "
            f"sdpa {r['library_call_ms']:.4f}")
    return out


def _timed(shape: str, kernel, plain, library, bound: float, by: str) -> dict:
    return dict(shape=shape, ms=_device_ms(kernel),
                plain_ms=_device_ms(plain), library_ms=_device_ms(library),
                call_ms=_call_ms(kernel), library_call_ms=_call_ms(library),
                bound_ms=bound, bound_by=by)


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


def profile_window(fn) -> dict:
    """Device busy time over one call of ``fn``, from a torch.profiler
    trace: the sum of CUDA kernel times over the call's host wall time, and
    the kernels that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                busy_share=busy_ms / wall_ms if busy_ms else None,
                kernel_launches=len(kernels),
                top_kernels_ms={k[:60]: round(v, 4) for k, v in top})


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

KERNELS = {
    "qkv_packed_attention": "mae_clip_tpu/ops/attention.py:303",
    "flash_attention": "mae_clip_tpu/ops/attention.py:76",
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from mae_clip_torch.ops import attention as A

    log(f"card: {card_line()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log("phase 1: build")
    build_kernels()
    log("phase 2: kernels vs plain versions")
    errs = check_kernels()

    log("phase 3: flagship serving path (ViT-S/16 + DistilBERT, bf16)")
    rng = np.random.default_rng(0)
    model = build_flagship("cuda", "bfloat16")
    A.qkv_packed_attention.launches = 0
    A.flash_attention.launches = 0
    e2e = serve_flagship(model, rng)
    launches = {name: getattr(A, name).launches for name in KERNELS}
    log(f"  kernel launches on the serving path: {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} never launched on the serving path")

    log("phase 4: card vs CPU embeddings")
    check_against_cpu(model, rng)

    log("phase 5: kernel times")
    times = time_kernels()
    log(f"end to end: {json.dumps(e2e)}")

    kernels = [dict(name=name, route="cuda",
                    source="mae_clip_torch/csrc/attention_fwd.cu",
                    replaces=replaces, launches=launches[name],
                    max_abs_err=errs[name], ms=times[name]["ms"],
                    plain_ms=times[name]["plain_ms"],
                    bound_ms=times[name]["bound_ms"],
                    bound_by=times[name]["bound_by"],
                    library_ms=times[name]["library_ms"])
               for name, replaces in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
