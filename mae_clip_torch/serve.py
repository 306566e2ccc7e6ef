"""Inference serving: embedding + retrieval over HTTP (``mae_clip_tpu/serve.py``).

The same service, micro-batcher, endpoints and JSON as the JAX package, over
the port's ``CLIPModel`` on its device (the card by default).

Endpoints:
  GET  /healthz                      -> {"status": "ok", ...}
  POST /embed_text {"texts": [...]}  -> {"embeddings": [[...], ...]}
  POST /embed_image {"images": [..HWC.. or N x HWC], "raw_uint8": bool}
                                     -> {"embeddings": [[...], ...]}
  POST /retrieve   {"query": "...", "n": 9}
                                     -> {"matches": [...], "scores": [...],
                                         "indices": [...]}
  POST /zeroshot   {"labels": [...], "image": [[..HWC..]], "raw_uint8": bool}
                                     -> {"probs": {label: p}}
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mae_clip_torch.data.tokenizer import pad_token_batch
from mae_clip_torch.eval.retrieval import _image_embed_fn, _text_embed_fn
from mae_clip_torch.ops.retrieval import (l2_normalize, quantize_embeddings,
                                          retrieval_topk,
                                          retrieval_topk_int8)


class Overloaded(RuntimeError):
    """The serving queue is over capacity (or a request aged past its
    deadline before reaching the device). Maps to HTTP 503."""


class MicroBatcher:
    """Dynamic request coalescing: the worker takes the first queued item,
    waits up to ``max_wait_ms`` for more (up to ``max_batch``) and runs ONE
    ``fn(items) -> results`` call for the batch. Callers block in ``submit``
    until their result is ready; an exception reaches every caller of the
    failed batch. ``max_queue`` caps the waiting items (``submit`` raises
    :class:`Overloaded` beyond it) and ``deadline_ms`` sheds items that
    waited that long before the worker reached them. Both default off.
    """

    _STOP = object()

    def __init__(self, fn: Callable[[List[Any]], List[Any]],
                 max_batch: int = 16, max_wait_ms: float = 5.0,
                 max_queue: Optional[int] = None,
                 deadline_ms: Optional[float] = None):
        self.fn = fn
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.max_queue = max_queue
        self.deadline = deadline_ms / 1e3 if deadline_ms else None
        self.batches_run = 0
        self.items_run = 0
        self.items_shed = 0
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, item: Any) -> Any:
        if self.max_queue is not None and self._q.qsize() >= self.max_queue:
            # qsize() is advisory under concurrency: the cap is a
            # load-shedding threshold, not an invariant.
            self.items_shed += 1
            raise Overloaded(
                f"serving queue at capacity ({self.max_queue} waiting)")
        ev = threading.Event()
        box: Dict[str, Any] = {}
        self._q.put((item, ev, box, time.monotonic()))
        ev.wait()
        if "error" in box:
            raise box["error"]
        return box["result"]

    def close(self) -> None:
        self._q.put(self._STOP)
        self._thread.join(timeout=5)

    def _shed_expired(self, batch):
        if self.deadline is None:
            return batch
        now = time.monotonic()
        keep = []
        for entry in batch:
            if now - entry[3] > self.deadline:
                entry[2]["error"] = Overloaded(
                    f"request waited > {self.deadline * 1e3:.0f} ms in "
                    f"the serving queue")
                entry[1].set()
                self.items_shed += 1
            else:
                keep.append(entry)
        return keep

    def _loop(self) -> None:
        while True:
            first = self._q.get()
            if first is self._STOP:
                return
            batch: List[Tuple[Any, threading.Event, Dict, float]] = [first]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is self._STOP:
                    self._q.put(self._STOP)   # re-queue for the outer loop
                    break
                batch.append(nxt)
            batch = self._shed_expired(batch)
            if not batch:
                continue
            try:
                results = self.fn([b[0] for b in batch])
                for (_, ev, box, _), r in zip(batch, results):
                    box["result"] = r
                    ev.set()
            except Exception as e:                 # noqa: BLE001
                for _, ev, box, _ in batch:
                    box["error"] = e
                    ev.set()
            self.batches_run += 1
            self.items_run += len(batch)


class RetrievalService:
    """Embedding/retrieval core shared by the server and tests. The gallery
    lives on the model's device, fp32 or (``quantize_gallery``) int8."""

    def __init__(self, model, tokenizer,
                 gallery: Optional[Any] = None,
                 gallery_names: Optional[Sequence[str]] = None,
                 max_length: Optional[int] = None,
                 dedup_stride: int = 1,
                 quantize_gallery: bool = False):
        self.model = model
        self.tokenizer = tokenizer
        self.gallery = (None if gallery is None else
                        torch.as_tensor(gallery).to(model.device))
        self.gallery_names = list(gallery_names or [])
        self.max_length = max_length
        self.dedup_stride = dedup_stride
        self.gallery_q = self.gallery_scales = None
        if self.gallery is not None and quantize_gallery:
            self.gallery_q, self.gallery_scales = quantize_embeddings(
                l2_normalize(self.gallery.float()))
            self.gallery = None
        self._embed_text = _text_embed_fn(model)
        self._embed_image = _image_embed_fn(model)
        self._batcher: Optional[MicroBatcher] = None

    # -- micro-batching ----------------------------------------------------
    def enable_micro_batching(self, max_batch: int = 16,
                              max_wait_ms: float = 5.0,
                              fixed_length: Optional[int] = None,
                              max_n: int = 50,
                              max_queue: Optional[int] = None,
                              deadline_ms: Optional[float] = None
                              ) -> MicroBatcher:
        """Coalesce concurrent /retrieve requests into one batched call.
        Shapes are pinned as in the JAX package: queries tokenised to
        ``fixed_length``, batches padded to ``max_batch``, top-k at
        ``dedup_stride * max_n`` clamped to the gallery size."""
        if not self.gallery_size:
            raise ValueError("micro-batching needs a gallery loaded")
        self._mb_fixed_length = fixed_length or self.max_length or 64
        self._mb_max_batch = max_batch
        self._mb_k = min(self.dedup_stride * max_n, self.gallery_size)
        self._mb_max_n = max_n
        self._batcher = MicroBatcher(self._retrieve_many,
                                     max_batch=max_batch,
                                     max_wait_ms=max_wait_ms,
                                     max_queue=max_queue,
                                     deadline_ms=deadline_ms)
        return self._batcher

    def _retrieve_many(self, items: List[Tuple[str, int]]) -> List[Dict]:
        enc = self.tokenizer.encode_batch(
            [q for q, _ in items], max_length=self._mb_fixed_length,
            fixed_length=self._mb_fixed_length)
        ids, mask = pad_token_batch(
            np.asarray(enc["input_ids"], np.int64),
            np.asarray(enc["attention_mask"], np.int64),
            self._mb_max_batch)
        scores, idx = self._topk(self._embed_text(ids, mask), self._mb_k)
        scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        return [self._result(idx[row], scores[row], min(n, self._mb_max_n))
                for row, (_, n) in enumerate(items)]

    def _result(self, idx: np.ndarray, scores: np.ndarray, n: int) -> Dict:
        ri = idx[::self.dedup_stride][:n]
        rs = scores[::self.dedup_stride][:n]
        names = ([self.gallery_names[i] for i in ri]
                 if self.gallery_names else ri.tolist())
        return {"matches": names, "scores": rs.tolist(),
                "indices": ri.tolist()}

    # -- API ---------------------------------------------------------------
    def embed_text(self, texts: Sequence[str]) -> np.ndarray:
        enc = self.tokenizer.encode_batch(list(texts),
                                          max_length=self.max_length)
        ids = np.asarray(enc["input_ids"], np.int64)
        mask = np.asarray(enc["attention_mask"], np.int64)
        return self._embed_text(ids, mask).cpu().numpy()

    def embed_images(self, images: np.ndarray) -> np.ndarray:
        return self._embed_image(np.asarray(images)).cpu().numpy()

    @property
    def gallery_size(self) -> int:
        if self.gallery is not None:
            return int(self.gallery.shape[0])
        if self.gallery_q is not None:
            return int(self.gallery_q.shape[0])
        return 0

    def _topk(self, emb: torch.Tensor, k: int):
        if self.gallery_q is not None:
            return retrieval_topk_int8(emb, self.gallery_q,
                                       self.gallery_scales, k=k)
        return retrieval_topk(emb, self.gallery, k=k)

    def retrieve(self, query: str, n: int = 9) -> Dict:
        if not self.gallery_size:
            raise ValueError("service has no gallery loaded")
        if self._batcher is not None:
            return self._batcher.submit((query, n))
        text_emb = torch.from_numpy(self.embed_text([query]))
        k = min(n * self.dedup_stride, self.gallery_size)
        scores, idx = self._topk(text_emb.to(self.model.device), k)
        return self._result(idx[0].cpu().numpy(), scores[0].cpu().numpy(), n)

    def zeroshot(self, labels: Sequence[str], image: np.ndarray,
                 template="a photo of a {}",
                 scale: float = 100.0) -> Dict[str, float]:
        """Label probabilities for one (H, W, C) image. ``template`` is a
        str or a sequence of str (CLIP prompt ensembling: per-template
        embeddings normalised, averaged per class, re-normalised)."""
        templates = ([template] if isinstance(template, str)
                     else list(template))
        per = l2_normalize(torch.from_numpy(self.embed_text(
            [t.format(l) for l in labels for t in templates])))
        cls = l2_normalize(per.reshape(len(labels), len(templates),
                                       -1).mean(dim=1))
        img = l2_normalize(torch.from_numpy(
            self.embed_images(np.asarray(image)[None])))
        sims = img @ cls.T
        m = self.model
        with torch.no_grad():
            if hasattr(m, "logit_bias"):
                # SigLIP: calibrated per-label sigmoid with the trained
                # scale and bias (arXiv:2303.15343 section 4.2).
                probs = torch.sigmoid(m.logit_scale.exp().cpu() * sims
                                      + m.logit_bias.cpu())
            elif hasattr(m, "logit_scale"):
                # Learnable temperature: the trained exp(s), clamped at 100
                # like the training loss.
                trained = torch.clamp(m.logit_scale.exp().cpu(), max=100.0)
                probs = torch.softmax(trained * sims, dim=-1)
            else:
                probs = torch.softmax(scale * sims, dim=-1)
        return {l: float(p) for l, p in zip(labels, probs[0].tolist())}


class _Server(ThreadingHTTPServer):
    # A listen backlog of 5 (the stdlib default) resets connections when a
    # burst of concurrent clients arrives; micro-batching wants bursts.
    request_queue_size = 128
    daemon_threads = True


def make_server(service: RetrievalService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, payload: Dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                payload = {
                    "status": "ok",
                    "gallery_size": service.gallery_size,
                    "backend": service.model.device.type,
                }
                b = service._batcher
                if b is not None:
                    payload["batcher"] = {
                        "batches_run": b.batches_run,
                        "items_run": b.items_run,
                        "items_shed": b.items_shed,
                    }
                self._send(200, payload)
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/embed_text":
                    emb = service.embed_text(req["texts"])
                    self._send(200, {"embeddings": emb.tolist()})
                elif self.path == "/embed_image":
                    # Images arrive resized to the model size. "raw_uint8":
                    # 0-255 pixels, ImageNet-normalised here; default:
                    # already-normalised floats (JSON carries no dtype).
                    raw = bool(req.get("raw_uint8", False))
                    imgs = np.asarray(req["images"],
                                      dtype=np.uint8 if raw else np.float32)
                    if imgs.ndim == 3:       # single (H, W, C) image
                        imgs = imgs[None]
                    emb = service.embed_images(imgs)
                    self._send(200, {"embeddings": emb.tolist()})
                elif self.path == "/retrieve":
                    self._send(200, service.retrieve(req["query"],
                                                     int(req.get("n", 9))))
                elif self.path == "/zeroshot":
                    img = np.asarray(
                        req["image"],
                        dtype=(np.uint8 if req.get("raw_uint8", False)
                               else np.float32))
                    self._send(200, {"probs": service.zeroshot(
                        req["labels"], img,
                        template=req.get("template", "a photo of a {}"))})
                else:
                    self._send(404, {"error": "not found"})
            except Overloaded as e:  # shed load: bounded tail, retryable
                self._send(503, {"error": f"Overloaded: {e}"})
            except Exception as e:  # surface errors as JSON, keep serving
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

    return _Server((host, port), Handler)


def serve_forever_in_thread(server: ThreadingHTTPServer) -> threading.Thread:
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t
