"""The 32k-batch recipe's mechanisms on their own terms (no JAX here).

On the CPU: the chunked losses keep no (B, chunk) score block for the
backward (each block is recomputed there), and GradCache's pass 2 sees the
same dropout masks and in-step crops as its pass 1 (the RNG states are
replayed per microbatch). On a CUDA card (tests marked ``cuda``),
``chip_smoke.py``'s phase-15 checks at small sizes: the chunked losses
against the unchunked ones in fp32 (value within 1e-5 relative, gradients
within 1e-5 of the largest entry), GradCache with remat and the chunked
loss against the one-pass step in bf16 (metrics within 1e-3 relative,
gradient cosines >= 0.999, norm ratios within 1e-2 of 1), and kernel #1
writing the same bits twice (the recompute that remat relies on), #1 and
#3 against their plain versions at the large-batch path's head widths. This file imports neither JAX nor the JAX
package, so the card-only tests run where those are not installed
(``pytest tests/test_torch_large_batch_card.py -m cuda --noconftest``).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from mae_clip_torch import config as torch_config
from mae_clip_torch.models import CLIPModel, DistilBertConfig, ViTConfig
from mae_clip_torch.ops import losses as L
from mae_clip_torch.train import TrainState, make_train_step
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _largest_saved(fn) -> int:
    """The element count of the largest tensor autograd keeps for the
    backward of ``fn()`` outside checkpointed regions."""
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return max(sizes)


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
def test_chunked_losses_keep_no_score_block(hard):
    """At 96 rows in blocks of 16 the unchunked loss keeps (96, 96) score
    matrices for its backward; the chunked one keeps nothing larger than
    the (96, 8) embeddings, yet gives the same gradients."""
    gen = torch.Generator().manual_seed(0)
    img, txt = (torch.randn(96, 8, generator=gen).requires_grad_()
                for _ in range(2))
    plain = L.clip_hard_ce_loss if hard else L.clip_soft_ce_loss
    chunked = L.clip_hard_ce_loss_chunked if hard else \
        L.clip_soft_ce_loss_chunked
    assert _largest_saved(lambda: plain(img, txt, 0.5)) >= 96 * 96
    assert _largest_saved(lambda: chunked(img, txt, 0.5, None, 16)) <= 96 * 8
    want = torch.autograd.grad(plain(img, txt, 0.5), (img, txt))
    got = torch.autograd.grad(chunked(img, txt, 0.5, None, 16), (img, txt))
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-5,
                                   atol=1e-5 * float(y.abs().max()))


def test_gradcache_replays_randomness():
    """GradCache with the projection heads' dropout (0.1), a trained text
    tower's dropout and attention dropout (0.1) and in-step crops of uint8
    sources (24 px to 16): each microbatch's embeddings in pass 2 are pass
    1's, bit for bit, and the microbatches draw different masks."""
    text = DistilBertConfig(vocab_size=50, dim=32, n_layers=2, n_heads=2,
                            hidden_dim=64, max_position_embeddings=32)
    cfg = torch_config.Config(
        model_name="vit_s16", image_embedding=32, projection_dim=8, size=16,
        batch_size=8, compute_dtype="float32", dropout=0.1,
        text_trainable=True, mae=torch_config.MAEConfig(
            enabled=True, mask_ratio=0.5, decoder_dim=32, decoder_depth=1,
            decoder_heads=2, aug_source_size=24))
    model = CLIPModel(cfg, text, ViTConfig(image_size=16, patch_size=8,
                                           dim=32, depth=2, n_heads=2),
                      device="cpu").init_weights(
                          torch.Generator().manual_seed(0))
    seen = []
    for head in (model.image_projection, model.text_projection):
        head.register_forward_hook(
            lambda mod, args, out: seen.append(out.detach().clone()))
    rng = np.random.default_rng(1)
    batch = {"image": torch.from_numpy(rng.integers(0, 256, (8, 24, 24, 3),
                                                    dtype=np.uint8)),
             "input_ids": torch.from_numpy(rng.integers(0, 50, (8, 9))),
             "attention_mask": torch.ones(8, 9, dtype=torch.long)}
    opt = torch.optim.SGD([p for p in model.parameters() if p.requires_grad],
                          lr=0.1)
    metrics = make_train_step(model, opt, cfg, accum_steps=4)(
        TrainState.create(model, opt), batch)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert len(seen) == 16          # 2 heads x 4 microbatches x 2 passes
    first, second = seen[:8], seen[8:]
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert not torch.equal(first[0], first[2])


@pytest.mark.cuda
def test_chunked_losses_match_unchunked_on_card(cuda):
    chip_smoke.check_chunked_losses(rows=1024, dim=64, chunks=(256, 300),
                                    memory_rows=2048, memory_chunk=256)


@pytest.mark.cuda
def test_gradcache_matches_one_pass_on_card(cuda):
    result = chip_smoke.check_gradcache_against_giant_batch(
        batch=16, accum=4, chunk=5)
    assert result["min_grad_cosine"] >= 0.999


@pytest.mark.cuda
def test_packed_forward_recompute_is_bit_exact_on_card(cuda):
    worst = {"qkv_packed_attention": 0.0}
    chip_smoke.check_large_batch_attention(
        worst, ((64, 50, 6, 64), (16, 197, 2, 128)))
    assert worst["qkv_packed_attention_bwd"] > 0.0
