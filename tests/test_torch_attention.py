"""The port's attention (mae_clip_torch.ops.attention) against the JAX package.

The plain PyTorch versions of the two CUDA kernels are held against JAX's
XLA path and its Pallas kernels in interpret mode, at the shapes of
tests/test_attention.py (S not a multiple of 8, masked keys, S=300 for
several key blocks), fp32, atol 2e-5 / rtol 1e-4. The kernels themselves run
only on a CUDA card (tests marked ``cuda``).
"""

import numpy as np
import pytest
import torch

from mae_clip_torch.ops import _build
from mae_clip_torch.ops import attention as A

TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def jx():
    """The JAX side, imported here so that the card-only tests of this file
    also run where JAX is not installed
    (``pytest tests/test_torch_attention.py -m cuda --noconftest``)."""
    import jax.numpy as jnp
    from mae_clip_tpu.ops import attention as jax_attn
    return jax_attn, jnp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _qkv(rng, b, h, sq, sk, d):
    return tuple(rng.normal(size=(b, h, s, d)).astype(np.float32)
                 for s in (sq, sk, sk))


def _torch(*xs):
    return tuple(None if x is None else torch.from_numpy(x) for x in xs)


@pytest.mark.parametrize("b,s,h,d", [(2, 13, 2, 16), (3, 40, 2, 32),
                                     (2, 16, 6, 8)])
@pytest.mark.parametrize("masked", [False, True])
def test_packed_plain_matches_jax(jx, b, s, h, d, masked):
    """qkv_packed_attention (CPU -> plain version) == JAX's unpack+XLA path
    and JAX's packed Pallas kernel in interpret mode."""
    jax_attn, jnp = jx
    rng = np.random.default_rng(7)
    qkv = rng.normal(size=(b, s, 3 * h * d)).astype(np.float32)
    kv = (rng.random((b, s)) > 0.25).astype(np.float32) if masked else None
    jkv = None if kv is None else jnp.asarray(kv)
    want_xla = np.asarray(jax_attn.fused_qkv_attention(
        jnp.asarray(qkv), h, key_valid=jkv, impl="xla"))
    want_pallas = np.asarray(jax_attn.qkv_packed_attention(
        jnp.asarray(qkv), jkv, h, 1.0 / d ** 0.5, True))
    got = A.fused_qkv_attention(*_torch(qkv), h,
                                key_valid=_torch(kv)[0]).numpy()
    assert got.shape == (b, s, h * d)
    np.testing.assert_allclose(got, want_xla, **TOL)
    np.testing.assert_allclose(got, want_pallas, **TOL)


@pytest.mark.parametrize("b,h,sq,sk,d,masked", [
    (2, 3, 37, 37, 16, False),   # unmasked, S not a multiple of 8
    (2, 2, 29, 29, 8, True),     # padding mask
    (1, 1, 300, 300, 8, False),  # several 128-key blocks
    (2, 2, 21, 11, 16, True),    # Sq != Sk (cross-attention)
])
def test_flash_plain_matches_jax(jx, b, h, sq, sk, d, masked):
    """flash_attention (CPU -> plain version) == JAX's Pallas flash kernel
    in interpret mode and JAX's XLA attention."""
    jax_attn, jnp = jx
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, b, h, sq, sk, d)
    kv = None
    if masked:
        kv = np.ones((b, sk), np.float32)
        kv[0, sk - 4:] = 0
        kv[1, 5:] = 0
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    scale = 1.0 / d ** 0.5
    want_pallas = np.asarray(jax_attn.flash_attention(
        jq, jk, jv, None if kv is None else jnp.asarray(kv), scale,
        128, 128, True))
    want_xla = np.asarray(jax_attn.attention_xla(
        jq, jk, jv, None if kv is None else jnp.asarray(kv).astype(bool),
        scale))
    got = A.multi_head_attention(*_torch(q, k, v, kv)).numpy()
    np.testing.assert_allclose(got, want_pallas, **TOL)
    np.testing.assert_allclose(got, want_xla, **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_attention_ref_matches_jax_xla(jx, masked):
    """attention_ref keeps HF's masking (finfo.min, q scaled first)."""
    jax_attn, jnp = jx
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 2, 2, 9, 9, 8)
    kv = None
    if masked:
        kv = np.ones((2, 9), bool)
        kv[1, 3:] = False
    want = np.asarray(jax_attn.attention_xla(
        *map(jnp.asarray, (q, k, v)),
        None if kv is None else jnp.asarray(kv)))
    got = A.attention_ref(*_torch(q, k, v, kv)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_cpu_wrappers_run_plain_and_count_nothing():
    """On CPU tensors the wrappers return their plain version exactly and
    launch no kernel."""
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.normal(size=(2, 5, 3 * 2 * 4)).astype(np.float32))
    before = (A.qkv_packed_attention.launches, A.flash_attention.launches)
    torch.testing.assert_close(A.qkv_packed_attention(qkv, None, 2),
                               A.qkv_packed_attention_ref(qkv, None, 2),
                               rtol=0, atol=0)
    q, k, v = A._unpack(qkv, 2)
    torch.testing.assert_close(A.flash_attention(q, k, v),
                               A.flash_attention_ref(q, k, v), rtol=0, atol=0)
    assert (A.qkv_packed_attention.launches,
            A.flash_attention.launches) == before


def test_non_cpu_tensors_never_fall_back_to_plain():
    """A tensor that is not on the CPU goes to the kernel or raises: on a
    device the kernels do not run on, the wrappers raise."""
    qkv = torch.empty(2, 5, 24, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        A.qkv_packed_attention(qkv, None, 2)
    q = torch.empty(2, 2, 5, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        A.flash_attention(q, q, q)


def test_build_is_lazy_and_targets_hopper():
    """Importing the package builds nothing; the library is keyed by source
    hash under build/kernels and compiled for sm_90a."""
    path = _build.library_path("attention_fwd.cu")
    assert path.parent == _build.BUILD_DIR
    assert path == _build.library_path("attention_fwd.cu")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert (_build.CSRC / "attention_fwd.cu").exists()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_kernel_matches_plain_on_card(cuda, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(4, 197, 3 * 3 * 128, generator=gen).to(cuda, dtype)
    kv = (torch.rand(4, 197, generator=gen) > 0.2).float().to(cuda)
    kv[:, 0] = 1
    before = A.qkv_packed_attention.launches
    got = A.qkv_packed_attention(qkv, kv, 3)
    torch.cuda.synchronize()
    assert A.qkv_packed_attention.launches == before + 1
    want = A.qkv_packed_attention_ref(qkv.float(), kv, 3)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32 else \
        dict(atol=2e-2, rtol=0)
    torch.testing.assert_close(got.float(), want, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_on_card(cuda, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(3, 147, 2, 128, generator=gen).to(cuda, dtype).transpose(1, 2)
    k, v = (torch.randn(3, 2, 50, 128, generator=gen).to(cuda, dtype)
            for _ in range(2))
    kv = torch.ones(3, 50, device=cuda)
    kv[1, 20:] = 0
    before = A.flash_attention.launches
    got = A.flash_attention(q, k, v, kv)
    torch.cuda.synchronize()
    assert A.flash_attention.launches == before + 1
    want = A.flash_attention_ref(q.float(), k.float(), v.float(), kv)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32 else \
        dict(atol=2e-2, rtol=0)
    torch.testing.assert_close(got.float(), want, **tol)


@pytest.mark.cuda
def test_kernel_backward_is_not_ported(cuda):
    """Inference only: a backward pass through either kernel raises until
    the backward kernels are ported."""
    qkv = torch.randn(2, 9, 3 * 2 * 64, device=cuda, dtype=torch.bfloat16,
                      requires_grad=True)
    with pytest.raises(NotImplementedError):
        A.qkv_packed_attention(qkv, None, 2).sum().backward()
    q = torch.randn(2, 2, 9, 64, device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    with pytest.raises(NotImplementedError):
        A.flash_attention(q, q, q).sum().backward()
