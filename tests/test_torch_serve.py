"""The port's serving path (mae_clip_torch.serve and what it calls) against
the JAX package's: same weights, tokenizer vocab and gallery; identical top-k
indices and scores within 1e-5 on fp32 and int8 galleries, micro-batching,
zero-shot probabilities for the three scoring rules, and the HTTP endpoints.
"""

import json
import math
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mae_clip_tpu import serve as jax_serve
from mae_clip_tpu.config import Config as JaxConfig
from mae_clip_tpu.data import pipeline as jax_pipeline
from mae_clip_tpu.data import tokenizer as jax_tok
from mae_clip_tpu.models.clip import CLIPModel as JaxCLIP
from mae_clip_tpu.models.distilbert import DistilBertConfig as JaxText
from mae_clip_tpu.models.vit import ViTConfig as JaxViT
from mae_clip_tpu.ops import retrieval as jax_ret
from mae_clip_torch.config import Config
from mae_clip_torch.data import tokenizer as torch_tok
from mae_clip_torch.interop.from_jax import state_dict_from_flax
from mae_clip_torch.models import CLIPModel, DistilBertConfig, ViTConfig
from mae_clip_torch.ops import retrieval as torch_ret
from mae_clip_torch.serve import (MicroBatcher, Overloaded, RetrievalService,
                                  make_server, serve_forever_in_thread)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CORPUS = ["a red square", "a blue circle", "a green dog", "two cats, sleeping"]
QUERIES = ("a red square", "a blue circle", "a green dog")
TEXT = dict(dim=16, n_layers=1, n_heads=2, hidden_dim=32,
            max_position_embeddings=32)
VIT = dict(image_size=16, patch_size=8, dim=16, depth=1, n_heads=2)
BASE = dict(model_name="vit_s16", projection_dim=8, size=16,
            compute_dtype="float32", max_length=16)
# Zero-shot scoring rule -> Config fields selecting it.
RULES = {"softmax": {}, "siglip": dict(contrastive_loss="siglip"),
         "temperature": dict(contrastive_loss="clip",
                             learnable_temperature=True, temperature=0.5)}


@pytest.fixture(scope="module")
def world():
    """JAX variables for each scoring rule, the port's twin models, the two
    tokenizers and a gallery."""
    vocab = jax_tok.build_vocab(CORPUS, vocab_size=64, min_frequency=1)
    jtok, ttok = jax_tok.WordPieceTokenizer(vocab), torch_tok.WordPieceTokenizer(
        torch_tok.build_vocab(CORPUS, vocab_size=64, min_frequency=1))
    text = dict(TEXT, vocab_size=len(vocab))
    jmodels = {rule: JaxCLIP(JaxConfig(**BASE, **kw),
                             text_config=JaxText(**text),
                             vit_config=JaxViT(**VIT))
               for rule, kw in RULES.items()}
    rng = np.random.default_rng(0)
    batch = {"image": jnp.asarray(rng.normal(size=(2, 16, 16, 3)), jnp.float32),
             "input_ids": jnp.asarray(rng.integers(0, len(vocab), (2, 8)),
                                      jnp.int32),
             "attention_mask": jnp.ones((2, 8), jnp.int32)}
    params = jax.tree_util.tree_map(
        np.asarray,
        jax.jit(jmodels["siglip"].init)(jax.random.PRNGKey(0), batch))["params"]
    plain = {k: v for k, v in params.items() if not k.startswith("logit_")}
    per_rule = {"siglip": params, "softmax": plain,
                "temperature": dict(plain, logit_scale=np.float32(math.log(2.0)))}
    jax_vars, ports = {}, {}
    for rule, p in per_rule.items():
        jax_vars[rule] = {"params": jax.tree_util.tree_map(jnp.asarray, p)}
        cfg = Config(**BASE, **RULES[rule])
        model = CLIPModel(cfg, DistilBertConfig(**text), ViTConfig(**VIT),
                          device="cpu")
        model.load_state_dict(state_dict_from_flax(
            p, cfg, DistilBertConfig(**text), ViTConfig(**VIT)), strict=True)
        ports[rule] = model
    gallery = rng.normal(size=(12, 8)).astype(np.float32)
    return dict(jmodels=jmodels, jax_vars=jax_vars, ports=ports, jtok=jtok,
                ttok=ttok, gallery=gallery,
                names=[f"img{i}.jpg" for i in range(12)])


def _services(w, rule="softmax", **kw):
    args = dict(gallery_names=w["names"], max_length=16, **kw)
    j = jax_serve.RetrievalService(w["jmodels"][rule], w["jax_vars"][rule],
                                   w["jtok"],
                                   gallery=jnp.asarray(w["gallery"]), **args)
    t = RetrievalService(w["ports"][rule], w["ttok"], gallery=w["gallery"],
                         **args)
    return j, t


def _same_results(got, want, atol=1e-5):
    assert got["indices"] == want["indices"]
    assert got["matches"] == want["matches"]
    np.testing.assert_allclose(got["scores"], want["scores"], atol=atol)


def test_tokenizer_matches_jax(world):
    texts = CORPUS + ["Café—naïve RED-square!", "", "dogs dogs dogs " * 8]
    assert world["ttok"].vocab == world["jtok"].vocab
    for kw in (dict(), dict(max_length=6), dict(max_length=16,
                                                fixed_length=16)):
        assert (world["ttok"].encode_batch(texts, **kw)
                == world["jtok"].encode_batch(texts, **kw))
    ids = np.arange(6, dtype=np.int64).reshape(2, 3)
    mask = np.ones((2, 3), np.int64)
    for got, want in zip(torch_tok.pad_token_batch(ids, mask, 5),
                         jax_pipeline.pad_token_batch(ids, mask, 5)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quantize", [False, True])
def test_retrieve_matches_jax(world, quantize):
    j, t = _services(world, dedup_stride=2, quantize_gallery=quantize)
    assert t.gallery_size == j.gallery_size == 12
    if quantize:
        assert t.gallery is None and t.gallery_q.dtype == torch.int8
        np.testing.assert_array_equal(t.gallery_q.numpy(),
                                      np.asarray(j.gallery_q))
    for q in QUERIES:
        _same_results(t.retrieve(q, n=4), j.retrieve(q, n=4))
    np.testing.assert_allclose(t.embed_text(CORPUS), j.embed_text(CORPUS),
                               atol=1e-5)


@pytest.mark.parametrize("quantize", [False, True])
def test_micro_batching_matches_jax(world, quantize):
    """Concurrent /retrieve calls coalesce and equal JAX's unbatched path."""
    j, t = _services(world, quantize_gallery=quantize)
    want = {q: j.retrieve(q, n=3) for q in QUERIES}
    batcher = t.enable_micro_batching(max_batch=8, max_wait_ms=50.0,
                                      fixed_length=16, max_n=5)
    try:
        results, lock = {}, threading.Lock()

        def worker(q):
            r = t.retrieve(q, n=3)
            with lock:
                results.setdefault(q, []).append(r)

        threads = [threading.Thread(target=worker, args=(q,))
                   for q in QUERIES for _ in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in threads)
        for q, rs in results.items():
            for r in rs:
                _same_results(r, want[q])
        assert batcher.items_run == 6 and batcher.batches_run < 6
    finally:
        batcher.close()


@pytest.mark.parametrize("rule", list(RULES))
def test_zeroshot_matches_jax(world, rule):
    """Softmax at 100, SigLIP's sigmoid with the trained scale and bias, and
    the learnable temperature's clamped exp(s), each as in JAX."""
    j, t = _services(world, rule=rule)
    img = np.random.default_rng(1).normal(size=(16, 16, 3)).astype(np.float32)
    labels = ["red", "blue", "dog"]
    for template in ("a photo of a {}", ["a {}", "the {} here"]):
        got = t.zeroshot(labels, img, template=template)
        want = j.zeroshot(labels, img, template=template)
        assert list(got) == labels
        np.testing.assert_allclose([got[l] for l in labels],
                                   [want[l] for l in labels], atol=1e-5)
    total = sum(got.values())
    assert (abs(total - 1.0) < 1e-5) == (rule != "siglip")


def _post(base, path, payload):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_http_endpoints_match_jax(world):
    from mae_clip_tpu.data.images import IMAGENET_MEAN, IMAGENET_STD

    j, t = _services(world, dedup_stride=2)
    server = make_server(t, port=0)
    serve_forever_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health == {"status": "ok", "gallery_size": 12,
                          "backend": "cpu"}

        emb = _post(base, "/embed_text", {"texts": ["a red square"]})
        np.testing.assert_allclose(emb["embeddings"],
                                   j.embed_text(["a red square"]), atol=1e-5)

        pix = np.random.default_rng(4).integers(0, 255, (16, 16, 3),
                                                dtype=np.uint8)
        normed = (pix / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        raw = _post(base, "/embed_image", {"images": pix.tolist(),
                                           "raw_uint8": True})
        pre = _post(base, "/embed_image",
                    {"images": [normed.tolist(), normed.tolist()]})
        want = j.embed_images(pix[None])
        np.testing.assert_allclose(raw["embeddings"], want, atol=1e-5)
        np.testing.assert_allclose(pre["embeddings"][1], want[0], atol=1e-4)

        _same_results(_post(base, "/retrieve", {"query": "a blue circle",
                                                "n": 3}),
                      j.retrieve("a blue circle", n=3))
        zs = _post(base, "/zeroshot", {"labels": ["red", "blue"],
                                       "image": pix.tolist(),
                                       "raw_uint8": True})["probs"]
        want_zs = j.zeroshot(["red", "blue"], pix)
        np.testing.assert_allclose([zs["red"], zs["blue"]],
                                   [want_zs["red"], want_zs["blue"]],
                                   atol=1e-5)

        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base, "/retrieve", {"n": 2})
        assert err.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base, "/nope", {})
        assert err.value.code == 404
    finally:
        server.shutdown()
        server.server_close()


def test_http_503_on_overload(world):
    _, t = _services(world)
    release = threading.Event()

    def slow_fn(items):
        release.wait(5)
        return [{"matches": [], "scores": [], "indices": []} for _ in items]

    t._batcher = MicroBatcher(slow_fn, max_batch=1, max_wait_ms=1.0,
                              max_queue=1)
    server = make_server(t)
    serve_forever_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    codes = []

    def post():
        try:
            _post(base, "/retrieve", {"query": "a dog"})
            codes.append(200)
        except urllib.error.HTTPError as e:
            codes.append(e.code)

    try:
        threads = [threading.Thread(target=post) for _ in range(4)]
        for th in threads:
            th.start()
            time.sleep(0.05)
        release.set()
        for th in threads:
            th.join(timeout=10)
        assert sorted(codes) == [200, 200, 503, 503], codes
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert json.loads(r.read())["batcher"]["items_shed"] == 2
    finally:
        release.set()
        t._batcher.close()
        server.shutdown()
        server.server_close()


def test_micro_batcher_error_propagates():
    def boom(items):
        raise RuntimeError("bad batch")

    b = MicroBatcher(boom, max_batch=4, max_wait_ms=1.0)
    try:
        with pytest.raises(RuntimeError, match="bad batch"):
            b.submit(("q", 1))
    finally:
        b.close()


def test_micro_batcher_respects_max_batch():
    calls = []

    def fn(items):
        calls.append(len(items))
        return items

    b = MicroBatcher(fn, max_batch=2, max_wait_ms=200.0)
    try:
        threads = [threading.Thread(target=b.submit, args=(i,))
                   for i in range(5)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=10)
        assert sum(calls) == 5 and all(c <= 2 for c in calls)
    finally:
        b.close()


def test_micro_batcher_sheds_by_queue_cap_and_deadline():
    release = threading.Event()

    def slow_fn(items):
        release.wait(5)
        return [x * 2 for x in items]

    b = MicroBatcher(slow_fn, max_batch=1, max_wait_ms=1.0, max_queue=2)
    results, errors = [], []

    def client(x):
        try:
            results.append(b.submit(x))
        except Overloaded as e:
            errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(6)]
        for th in threads:
            th.start()
            time.sleep(0.05)
        release.set()
        for th in threads:
            th.join(timeout=5)
        assert len(errors) == 3 and sorted(results) == [0, 2, 4]
    finally:
        release.set()
        b.close()

    seen, gate = [], threading.Event()

    def fn(items):
        seen.append(list(items))
        if not gate.is_set():
            gate.set()
            time.sleep(0.4)     # the next queued item goes stale
        return [x * 2 for x in items]

    b = MicroBatcher(fn, max_batch=1, max_wait_ms=1.0, deadline_ms=100.0)
    out = {}

    def client2(x):
        try:
            out[x] = b.submit(x)
        except Overloaded:
            out[x] = "shed"

    try:
        t1 = threading.Thread(target=client2, args=(1,))
        t2 = threading.Thread(target=client2, args=(2,))
        t1.start()
        gate.wait(5)
        t2.start()
        t1.join(timeout=5)
        t2.join(timeout=5)
        assert out == {1: 2, 2: "shed"} and seen == [[1]]
        assert b.items_shed == 1
    finally:
        b.close()


@pytest.mark.parametrize("n,chunk", [(40, 8192), (40, 16), (37, 8)])
def test_chunked_topk_matches_jax(n, chunk):
    """Running top-k over chunks (fp32 and int8) equals JAX's scan."""
    rng = np.random.default_rng(n + chunk)
    q = rng.normal(size=(3, 8)).astype(np.float32)
    g = rng.normal(size=(n, 8)).astype(np.float32)
    js, ji = jax_ret.retrieval_topk(jnp.asarray(q), jnp.asarray(g), k=7,
                                    chunk_size=chunk)
    ts, ti = torch_ret.retrieval_topk(torch.from_numpy(q), torch.from_numpy(g),
                                      k=7, chunk_size=chunk)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)

    jq, jsc = jax_ret.quantize_embeddings(jax_ret.l2_normalize(jnp.asarray(g)))
    tq, tsc = torch_ret.quantize_embeddings(
        torch_ret.l2_normalize(torch.from_numpy(g)))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-6)
    js, ji = jax_ret.retrieval_topk_int8(jnp.asarray(q), jq, jsc, k=7,
                                         chunk_size=chunk)
    ts, ti = torch_ret.retrieval_topk_int8(torch.from_numpy(q), tq, tsc, k=7,
                                           chunk_size=chunk)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    np.testing.assert_array_equal(
        torch_ret.strided_dedup(ti, 2, 3).numpy(),
        np.asarray(jax_ret.strided_dedup(ji, 2, 3)))
