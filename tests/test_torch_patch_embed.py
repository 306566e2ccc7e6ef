"""The masked patch-embed wrapper (mae_clip_torch.ops.patch_embed) and its
CUDA kernel.

On the CPU the wrapper runs the plain version (held against JAX's Pallas
kernel in tests/test_torch_pretrain.py) and its backward is plain torch;
here that backward is held against torch's autograd of the plain version,
and ``PatchEmbed``'s two routes against each other. The kernel runs only on
a CUDA card (tests marked ``cuda``), where it is held against the plain
version: fp32 atol 1e-4 / rtol 1e-4; bf16 max abs error <= 2e-2 *
max(1, max |plain|). This file imports no JAX, so the card-only tests run
where JAX is not installed
(``pytest tests/test_torch_patch_embed.py -m cuda --noconftest``).
"""

import pytest
import torch

from mae_clip_torch.models.vit import PatchEmbed, ViTConfig
from mae_clip_torch.ops import _build
from mae_clip_torch.ops.patch_embed import (masked_patch_embed,
                                            masked_patch_embed_ref)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# (B, N, Din, K, Dm): the MAE-pretrain step's shape at B=256 (tensor-core
# body), an odd one with a ragged last row tile (tensor-core body), widths
# that are not multiples of 8 (the scalar body, also in bf16), and one with
# M = B*K = 145 (one ragged 128-row tile), a last 64-deep K stage partly
# past Din = 200, and a ragged 128-column tile (Dm = 136; tensor-core body).
SHAPES = [(256, 196, 768, 49, 384), (3, 20, 48, 7, 40), (2, 9, 30, 5, 13),
          (5, 40, 200, 29, 136)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(shape, seed, device="cpu", dtype=torch.float32):
    b, n, d_in, k, d_m = shape
    gen = torch.Generator().manual_seed(seed)
    patches = torch.randn(b, n, d_in, generator=gen)
    ids = torch.argsort(torch.rand(b, n, generator=gen), dim=1)[:, :k]
    w = torch.randn(d_m, d_in, generator=gen) * d_in ** -0.5
    bias = torch.randn(d_m, generator=gen)
    return (patches.to(device, dtype), ids.to(device), w.to(device, dtype),
            bias.to(device, dtype))


@pytest.mark.parametrize("shape", SHAPES[1:])
def test_cpu_backward_matches_autograd_of_plain(shape):
    """The wrapper's own backward (dW, db, and dpatches scattered back with
    index_add_) against autograd through the plain version, with a repeated
    index so that two rows add into one patch."""
    p, ids, w, b = _inputs(shape, 0)
    ids[0, 1] = ids[0, 0]
    g = torch.randn(ids.shape[0], ids.shape[1], w.shape[0],
                    generator=torch.Generator().manual_seed(1))
    xs = [t.clone().requires_grad_() for t in (p, w, b)]
    ys = [t.clone().requires_grad_() for t in (p, w, b)]
    before = masked_patch_embed.launches
    out = masked_patch_embed(xs[0], ids, xs[1], xs[2])
    assert masked_patch_embed.launches == before
    want = masked_patch_embed_ref(ys[0], ids, ys[1], ys[2])
    torch.testing.assert_close(out, want, atol=0, rtol=0)
    for got, ref in zip(torch.autograd.grad(out, xs, g),
                        torch.autograd.grad(want, ys, g)):
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


def test_patch_embed_routes_agree_on_cpu():
    """PatchEmbed(ids) by the default route (gather, then Dense) and by the
    masked kernel's route agree at fp32; without ids both project every
    patch."""
    cfg = ViTConfig(image_size=32, patch_size=8, dim=24)
    plain = PatchEmbed(cfg)
    fused = PatchEmbed(cfg, masked_kernel=True)
    fused.load_state_dict(plain.state_dict())
    x = torch.randn(3, 32, 32, 3, generator=torch.Generator().manual_seed(2))
    ids = torch.argsort(torch.rand(3, 16), dim=1)[:, :5]
    with torch.no_grad():
        torch.testing.assert_close(fused(x, ids), plain(x, ids), atol=1e-5,
                                   rtol=1e-5)
        torch.testing.assert_close(fused(x), plain(x), atol=0, rtol=0)


def test_wrapper_checks_inputs_off_the_cpu():
    """Off the CPU the wrapper takes only CUDA tensors (a meta tensor here)
    and builds nothing on import."""
    p, ids, w, b = _inputs(SHAPES[1], 3, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        masked_patch_embed(p, ids, w, b)
    assert "patch_embed.cu" in _build.SOURCES
    assert _build.library_path("patch_embed.cu").parent == _build.BUILD_DIR


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain_on_card(cuda, dtype, shape):
    torch.backends.cuda.matmul.allow_tf32 = False
    p, ids, w, b = _inputs(shape, 4, cuda, dtype)
    before = masked_patch_embed.launches
    got = masked_patch_embed(p, ids, w, b)
    torch.cuda.synchronize()
    assert masked_patch_embed.launches == before + 1
    assert got.dtype == dtype and got.shape == (shape[0], shape[3], shape[4])
    want = masked_patch_embed_ref(p.float(), ids, w.float(), b.float())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        atol = 2e-2 * max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got.float(), want, atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_autograd_on_card(cuda, dtype):
    """Forward through the kernel, backward plain: the gradients match
    autograd through the plain version on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    p, ids, w, b = _inputs(SHAPES[1], 5, cuda, dtype)
    g = torch.randn(3, 7, 40, generator=torch.Generator().manual_seed(6)
                    ).to(cuda, dtype)
    xs = [t.clone().requires_grad_() for t in (p, w, b)]
    ys = [t.float().clone().requires_grad_() for t in (p, w, b)]
    got = torch.autograd.grad(masked_patch_embed(xs[0], ids, xs[1], xs[2]),
                              xs, g)
    want = torch.autograd.grad(masked_patch_embed_ref(ys[0], ids, ys[1], ys[2]),
                               ys, g.float())
    for x, y in zip(got, want):
        assert x.dtype == dtype
        atol = 1e-4 if dtype == torch.float32 else \
            2e-2 * max(1.0, float(y.abs().max()))
        torch.testing.assert_close(x.float(), y, atol=atol, rtol=1e-4)


@pytest.mark.cuda
def test_kernel_out_of_range_index_gives_nan_row(cuda):
    p, ids, w, b = _inputs(SHAPES[1], 7, cuda, torch.bfloat16)
    ids[1, 2] = p.shape[1]
    out = masked_patch_embed(p, ids, w, b).float()
    torch.cuda.synchronize()
    assert bool(out[1, 2].isnan().all())
    out[1, 2] = 0
    assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
def test_kernel_misaligned_patches_take_the_scalar_body_on_card(cuda):
    """``patches`` 2 bytes past a 16-byte boundary: the tensor-core body
    takes only 16-byte aligned rows, so the call runs the scalar body and
    gives the plain version's result, not a device fault."""
    p, ids, w, b = _inputs(SHAPES[3], 8, cuda, torch.bfloat16)
    storage = torch.empty(p.numel() + 8, dtype=p.dtype, device=cuda)
    shifted = storage[1:1 + p.numel()].view(p.shape)
    shifted.copy_(p)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    before = masked_patch_embed.launches
    got = masked_patch_embed(shifted, ids, w, b)
    torch.cuda.synchronize()
    assert masked_patch_embed.launches == before + 1
    want = masked_patch_embed_ref(p.float(), ids, w.float(), b.float())
    atol = 2e-2 * max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=0)


@pytest.mark.cuda
def test_kernel_out_of_range_indices_in_ragged_tiles_give_nan_rows(cuda):
    """On the tensor-core body at the ragged shape: an index past N and a
    negative one each give a row of NaN, in the last (ragged) row tile and
    in the first; every other row matches the plain version."""
    p, ids, w, b = _inputs(SHAPES[3], 9, cuda, torch.bfloat16)
    want = masked_patch_embed_ref(p.float(), ids, w.float(), b.float())
    ids[4, 28] = p.shape[1]
    ids[0, 3] = -1
    out = masked_patch_embed(p, ids, w, b).float()
    torch.cuda.synchronize()
    bad = torch.zeros(ids.shape, dtype=torch.bool, device=cuda)
    bad[4, 28] = bad[0, 3] = True
    assert bool(out[bad].isnan().all())
    atol = 2e-2 * max(1.0, float(want.abs().max()))
    torch.testing.assert_close(out[~bad], want[~bad], atol=atol, rtol=0)
