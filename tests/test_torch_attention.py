"""The port's attention (mae_clip_torch.ops.attention) against the JAX package.

The plain PyTorch versions of the four CUDA kernels (two forward, two
backward) are held against JAX's XLA path and its Pallas kernels in
interpret mode (``jax.vjp`` for the backward), at the shapes of
tests/test_attention.py (S not a multiple of 8, masked keys with no fully
masked row, S=300 for several key blocks, Sq != Sk), fp32, atol 2e-5 /
rtol 1e-4. The kernels themselves run only on a CUDA card (tests marked
``cuda``), where they are held against the plain versions.
"""

import numpy as np
import pytest
import torch

from mae_clip_torch.ops import _build
from mae_clip_torch.ops import attention as A
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

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


def _flash_mask(b, sk):
    kv = np.ones((b, sk), np.float32)
    kv[0, sk - 4:] = 0
    if b > 1:
        kv[1, 5:] = 0
    return kv


@pytest.fixture(scope="module")
def flash_vjp(jx):
    """``case -> (q, k, v, key_valid, d_out, out, (dq, dk, dv))``: the
    forward and jax.vjp of the Pallas flash kernel (interpret mode), which
    runs _flash_fwd_kernel and _flash_bwd_kernel, on seeded inputs;
    computed once per case. With ``masked == "fully"`` row 0's keys are all
    masked, where the Pallas kernels pad Sk (ROADMAP section 3): there the
    reference is jax.vjp of attention_xla, whose semantics the port
    follows."""
    import jax

    jax_attn, jnp = jx
    cache = {}

    def get(b, h, sq, sk, d, masked):
        key = (b, h, sq, sk, d, masked)
        if key not in cache:
            rng = np.random.default_rng(11)
            q, k, v = _qkv(rng, b, h, sq, sk, d)
            g = rng.normal(size=(b, h, sq, d)).astype(np.float32)
            kv = _flash_mask(b, sk) if masked else None
            scale = 1.0 / d ** 0.5
            if masked == "fully":
                kv[0] = 0
                out, vjp = jax.vjp(lambda x, y, z: jax_attn.attention_xla(
                    x, y, z, jnp.asarray(kv > 0), scale),
                    *map(jnp.asarray, (q, k, v)))
            else:
                jkv = None if kv is None else jnp.asarray(kv)
                out, vjp = jax.vjp(lambda x, y, z: jax_attn.flash_attention(
                    x, y, z, jkv, scale, 128, 128, True),
                    *map(jnp.asarray, (q, k, v)))
            want = tuple(np.asarray(x) for x in vjp(jnp.asarray(g)))
            cache[key] = (q, k, v, kv, g, np.asarray(out), want)
        return cache[key]

    return get


@pytest.mark.parametrize("b,h,sq,sk,d,masked", [
    (2, 2, 21, 11, 16, True),    # Sq != Sk, S not a multiple of 8, masked
    (1, 1, 300, 300, 8, False),  # several 128-key blocks
    (2, 2, 70, 13, 16, True),    # Sq > 64 >= Sk (one kernel #4 on the card)
    (2, 2, 70, 13, 16, "fully"),  # the same with a fully masked row
    (1, 2, 9, 7, 256, True),     # heads of 256
])
def test_flash_plain_backward_matches_jax(flash_vjp, b, h, sq, sk, d,
                                          masked):
    """Both plain backwards of kernel #4 == jax.vjp of the Pallas flash
    kernel (interpret mode), which runs _flash_bwd_kernel: the one that
    recomputes the statistics, and the one that takes the plain (out, lse)
    forward's output and log-sum-exp. That forward's output == JAX's, and
    its lse (B, H, Sq) == torch.logsumexp of the masked, scaled scores."""
    q, k, v, kv, g, want_out, want = flash_vjp(b, h, sq, sk, d, masked)
    qt, kt, vt, kvt = _torch(q, k, v, kv)
    gt = torch.from_numpy(g)
    scale = 1.0 / d ** 0.5
    got = A.flash_attention_bwd_ref(qt, kt, vt, kvt, scale, gt)
    for name, x, y in zip("qkv", got, want):
        np.testing.assert_allclose(x.numpy(), y, **TOL, err_msg=f"d{name}")
    out, lse = A.flash_attention_lse_ref(qt, kt, vt, kvt, scale)
    np.testing.assert_allclose(out.numpy(), want_out, **TOL)
    scores = torch.matmul(qt, kt.transpose(-1, -2)) * scale
    if kvt is not None:
        scores = scores.masked_fill(kvt[:, None, None, :] == 0, A.MASK_VALUE)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, torch.logsumexp(scores, dim=-1),
                               atol=1e-5, rtol=1e-6)
    got = A.flash_attention_bwd_lse_ref(qt, kt, vt, kvt, scale, out, lse, gt)
    for name, x, y in zip("qkv", got, want):
        np.testing.assert_allclose(x.numpy(), y, **TOL,
                                   err_msg=f"d{name} from out and lse")


PACKED_BWD_CASES = [
    (2, 13, 2, 16, True),    # S not a multiple of 8, masked (no full row)
    (1, 300, 1, 8, False),   # long sequence
]


@pytest.fixture(scope="module")
def packed_vjp(jx):
    """``case -> (qkv, d_out, key_valid, d_qkv)``: jax.vjp of the packed
    Pallas kernel (interpret mode), which runs _qkv_bwd_kernel, on seeded
    inputs; computed once per case for every plain backward held against
    it."""
    import jax

    jax_attn, jnp = jx
    cache = {}

    def get(b, s, h, d, masked):
        if (b, s, h, d, masked) not in cache:
            rng = np.random.default_rng(12)
            qkv = rng.normal(size=(b, s, 3 * h * d)).astype(np.float32)
            g = rng.normal(size=(b, s, h * d)).astype(np.float32)
            kv = None
            if masked:
                kv = (rng.random((b, s)) > 0.25).astype(np.float32)
                kv[:, 0] = 1                          # no fully masked row
            jkv = None if kv is None else jnp.asarray(kv)
            _, vjp = jax.vjp(lambda x: jax_attn.qkv_packed_attention(
                x, jkv, h, 1.0 / d ** 0.5, True), jnp.asarray(qkv))
            (want,) = vjp(jnp.asarray(g))
            cache[b, s, h, d, masked] = (qkv, g, kv, np.asarray(want))
        return cache[b, s, h, d, masked]

    return get


@pytest.mark.parametrize("b,s,h,d,masked", PACKED_BWD_CASES)
def test_packed_plain_backward_matches_jax(packed_vjp, b, s, h, d, masked):
    """qkv_packed_attention_bwd_ref == jax.vjp of the packed Pallas kernel
    (interpret mode), which runs _qkv_bwd_kernel; d_qkv in packed columns."""
    qkv, g, kv, want = packed_vjp(b, s, h, d, masked)
    got = A.qkv_packed_attention_bwd_ref(*_torch(qkv, kv), h, None,
                                         torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("b,s,h,d,masked", PACKED_BWD_CASES)
def test_packed_plain_lse_backward_matches_jax(packed_vjp, b, s, h, d,
                                               masked):
    """The plain version of kernel #3 as the card runs it (from the plain
    forward's out and lse, delta = rowsum(dO * out)) == jax.vjp of the
    packed Pallas kernel, which recomputes the statistics."""
    qkv, g, kv, want = packed_vjp(b, s, h, d, masked)
    qkv_t, kv_t = _torch(qkv, kv)
    out, lse = A.qkv_packed_attention_lse_ref(qkv_t, kv_t, h)
    got = A.qkv_packed_attention_bwd_lse_ref(qkv_t, kv_t, h, None, out, lse,
                                             torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _lse_case(mask: str):
    rng = np.random.default_rng(15)
    b, s, h, d = 3, 13, 2, 16
    qkv = torch.from_numpy(rng.normal(size=(b, s, 3 * h * d)).astype(
        np.float32))
    g = torch.from_numpy(rng.normal(size=(b, s, h * d)).astype(np.float32))
    kv = None
    if mask != "none":
        kv = torch.from_numpy((rng.random((b, s)) > 0.3).astype(np.float32))
        kv[:, 0] = 1
        if mask == "fully":
            kv[1] = 0                                 # every key masked
    return qkv, g, kv, h, d


@pytest.mark.parametrize("mask", ["none", "padding", "fully"])
def test_plain_lse_forward_matches_plain_forward(mask):
    """qkv_packed_attention_lse_ref: out == qkv_packed_attention_ref
    exactly, and lse (B*H, S) == torch.logsumexp of the masked, scaled
    scores (MASK_VALUE on a row whose keys are all masked)."""
    qkv, _, kv, h, d = _lse_case(mask)
    out, lse = A.qkv_packed_attention_lse_ref(qkv, kv, h)
    torch.testing.assert_close(out, A.qkv_packed_attention_ref(qkv, kv, h),
                               rtol=0, atol=0)
    q, k, _ = A._unpack(qkv, h)
    scores = torch.matmul(q, k.transpose(-1, -2)) / d ** 0.5
    if kv is not None:
        scores = scores.masked_fill(kv[:, None, None, :] == 0, A.MASK_VALUE)
    want = torch.logsumexp(scores, dim=-1).reshape(lse.shape)
    assert lse.shape == (qkv.shape[0] * h, qkv.shape[1])
    assert lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("mask", ["none", "padding", "fully"])
def test_plain_lse_backward_matches_recompute_backward(mask):
    """The two plain backwards of kernel #3 agree (fp32): from the saved
    out and lse, and recomputing the statistics, a fully masked row
    included (uniform P, no dq or dk)."""
    qkv, g, kv, h, _ = _lse_case(mask)
    out, lse = A.qkv_packed_attention_lse_ref(qkv, kv, h)
    got = A.qkv_packed_attention_bwd_lse_ref(qkv, kv, h, None, out, lse, g)
    want = A.qkv_packed_attention_bwd_ref(qkv, kv, h, None, g)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_backward_matches_autograd(packed, masked):
    """Each plain backward == torch autograd of its plain forward (fp64, so
    the two differ only by the order of sums)."""
    rng = np.random.default_rng(13)
    b, h, s, d = 2, 2, 19, 8
    kv = None
    if masked:
        kv = torch.from_numpy((rng.random((b, s)) > 0.3).astype(np.float32))
        kv[:, 0] = 1
    if packed:
        x = torch.from_numpy(rng.normal(size=(b, s, 3 * h * d))
                             ).double().requires_grad_()
        g = torch.from_numpy(rng.normal(size=(b, s, h * d))).double()
        want = torch.autograd.grad(A.qkv_packed_attention_ref(x, kv, h),
                                   x, g)
        got = (A.qkv_packed_attention_bwd_ref(x.detach(), kv, h, None, g),)
    else:
        x = [torch.from_numpy(rng.normal(size=(b, h, n, d))).double()
             .requires_grad_() for n in (s, s - 4, s - 4)]
        kv = None if kv is None else kv[:, :s - 4]
        g = torch.from_numpy(rng.normal(size=(b, h, s, d))).double()
        want = torch.autograd.grad(A.flash_attention_ref(*x, kv), x, g)
        got = A.flash_attention_bwd_ref(*(t.detach() for t in x), kv, None, g)
    for w, y in zip(want, got):
        torch.testing.assert_close(y.double(), w, atol=1e-5, rtol=1e-5)


def test_fully_masked_row_follows_jax_xla(jx):
    """A row whose keys are all masked: uniform weights over the Sk real keys
    and no gradient into q or k, as JAX's attention_xla gives (the JAX
    Pallas kernels pad Sk and differ there; ROADMAP section 3)."""
    import jax

    jax_attn, jnp = jx
    rng = np.random.default_rng(14)
    b, h, s, d = 2, 2, 20, 16
    q, k, v = _qkv(rng, b, h, s, s, d)
    g = rng.normal(size=(b, h, s, d)).astype(np.float32)
    kv = np.ones((b, s), np.float32)
    kv[0] = 0                                         # every key masked
    kv[1, 7:] = 0
    want_out, vjp = jax.vjp(lambda x, y, z: jax_attn.attention_xla(
        x, y, z, jnp.asarray(kv > 0)), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    xs = [t.requires_grad_() for t in _torch(q, k, v)]
    out = A.flash_attention(*xs, torch.from_numpy(kv))
    got = torch.autograd.grad(out, xs, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               **TOL)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL)
    assert float(got[0][0].abs().max()) == 0.0
    # JAX's Pallas forward pads Sk to 128 and its padded keys (k = v = 0)
    # join such a row's softmax: there it gives the port's output x Sk/128.
    pallas = np.asarray(jax_attn.flash_attention(
        *map(jnp.asarray, (q, k, v)), jnp.asarray(kv), 1.0 / d ** 0.5,
        128, 128, True))
    np.testing.assert_allclose(pallas[0], out.detach().numpy()[0] * s / 128,
                               **TOL)
    np.testing.assert_allclose(pallas[1], out.detach().numpy()[1], **TOL)


def _counts():
    return tuple(getattr(w, f) for w in (A.qkv_packed_attention,
                                         A.flash_attention)
                 for f in ("launches", "bwd_launches"))


def test_cpu_wrappers_run_plain_and_count_nothing():
    """On CPU tensors the wrappers return their plain version exactly and
    launch no kernel."""
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.normal(size=(2, 5, 3 * 2 * 4)).astype(np.float32))
    before = _counts()
    torch.testing.assert_close(A.qkv_packed_attention(qkv, None, 2),
                               A.qkv_packed_attention_ref(qkv, None, 2),
                               rtol=0, atol=0)
    q, k, v = A._unpack(qkv, 2)
    torch.testing.assert_close(A.flash_attention(q, k, v),
                               A.flash_attention_ref(q, k, v), rtol=0, atol=0)
    assert _counts() == before


def test_cpu_backward_runs_plain_and_counts_nothing():
    """A backward pass through either wrapper on the CPU returns the plain
    backward exactly and launches nothing."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.normal(size=(2, 9, 3 * 2 * 4)).astype(
        np.float32)).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(2, 9, 8)).astype(np.float32))
    kv = torch.ones(2, 9)
    kv[1, 4:] = 0
    before = _counts()
    (got,) = torch.autograd.grad(A.qkv_packed_attention(qkv, kv, 2), qkv, g)
    torch.testing.assert_close(
        got, A.qkv_packed_attention_bwd_ref(qkv.detach(), kv, 2, None, g),
        rtol=0, atol=0)
    q, k, v = (t.detach().requires_grad_() for t in A._unpack(qkv, 2))
    gq = g.reshape(2, 9, 2, 4).transpose(1, 2)        # a strided d_out
    got = torch.autograd.grad(A.flash_attention(q, k, v, kv), (q, k, v), gq)
    want = A.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), kv,
                                     None, gq)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert _counts() == before


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
def test_kernel_backward_launches_once_with_finite_grads(cuda):
    """The backward kernels once were not ported and a backward pass through
    a kernel wrapper raised; now it launches backward kernel #3 / #4 once
    per call and returns finite gradients of the inputs' shapes."""
    qkv = torch.randn(2, 9, 3 * 2 * 64, device=cuda, dtype=torch.bfloat16,
                      requires_grad=True)
    before = A.qkv_packed_attention.bwd_launches
    A.qkv_packed_attention(qkv, None, 2).sum().backward()
    assert A.qkv_packed_attention.bwd_launches == before + 1
    assert qkv.grad.shape == qkv.shape and torch.isfinite(qkv.grad).all()
    q = torch.randn(2, 2, 9, 64, device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    before = A.flash_attention.bwd_launches
    A.flash_attention(q, q, q).sum().backward()
    assert A.flash_attention.bwd_launches == before + 1
    assert q.grad.shape == q.shape and torch.isfinite(q.grad).all()


def _close_to_plain(got, want, dtype):
    """fp32: atol 1e-4 / rtol 1e-4. bf16 (against the plain version in fp32
    on the same bf16 values): max abs error <= 2e-2 * max(1, max |plain|)."""
    if dtype == torch.float32:
        torch.testing.assert_close(got.float(), want.float(), atol=1e-4,
                                   rtol=1e-4)
    else:
        err = float((got.float() - want.float()).abs().max())
        assert err <= 2e-2 * max(1.0, float(want.abs().max())), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,masked", [(6, 50, False), (4, 197, True)])
def test_packed_backward_kernel_matches_plain_on_card(cuda, dtype, b, s,
                                                      masked):
    """Kernel #3 through autograd of the wrapper == the plain backward."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(2)
    qkv = torch.randn(b, s, 3 * 3 * 128, generator=gen).to(cuda, dtype)
    g = torch.randn(b, s, 3 * 128, generator=gen).to(cuda, dtype)
    kv = None
    if masked:
        kv = (torch.rand(b, s, generator=gen) > 0.2).float().to(cuda)
        kv[:, 0] = 1
    x = qkv.clone().requires_grad_()
    before = A.qkv_packed_attention.bwd_launches
    (got,) = torch.autograd.grad(A.qkv_packed_attention(x, kv, 3), x, g)
    torch.cuda.synchronize()
    assert A.qkv_packed_attention.bwd_launches == before + 1
    want = A.qkv_packed_attention_bwd_ref(qkv.float(), kv, 3, None, g.float())
    _close_to_plain(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,sq,sk,d,masked", [
    (3, 2, 147, 50, 128, False),   # the CrossMAE decoder's shape
    (2, 2, 300, 300, 128, True),   # several tiles each way
    (2, 3, 33, 40, 80, True),      # Dh 80
    (3, 2, 147, 50, 64, True),     # Sk <= 64 < Sq at Dh 64
    (3, 2, 70, 13, 128, True),     # Sk <= 64 < Sq, a ragged last stage
    (2, 2, 147, 50, 256, True),    # Dh 256
    (2, 3, 64, 64, 256, True),     # Dh 256, one tile each way
])
def test_flash_backward_kernel_matches_plain_on_card(cuda, dtype, b, h, sq,
                                                     sk, d, masked):
    """Kernel #4 through autograd of the wrapper, on strided (B, S, H, Dh)
    views with a fully masked row, == the plain backward that recomputes the
    statistics and the one that takes #2's output and lse; one launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(b, n, h, d, generator=gen).to(cuda, dtype)
               .transpose(1, 2).requires_grad_() for n in (sq, sk, sk))
    g = torch.randn(b, h, sq, d, generator=gen).to(cuda, dtype)
    kv = None
    if masked:
        kv = torch.ones(b, sk, device=cuda)
        kv[0] = 0                      # fully masked: uniform P, no dq/dk
        kv[1, sk // 3:] = 0
    before = A.flash_attention.bwd_launches
    got = torch.autograd.grad(A.flash_attention(q, k, v, kv), (q, k, v), g)
    torch.cuda.synchronize()
    assert A.flash_attention.bwd_launches == before + 1
    plain = [t.detach().float() for t in (q, k, v)]
    want = A.flash_attention_bwd_ref(*plain, kv, None, g.float())
    for x, y in zip(got, want):
        _close_to_plain(x, y, dtype)
    out, lse = A._launch_flash(q.detach(), k.detach(), v.detach(), kv,
                               d ** -0.5, with_lse=True)
    want = A.flash_attention_bwd_lse_ref(*plain, kv, None, out.float(), lse,
                                         g.float())
    for x, y in zip(got, want):
        _close_to_plain(x, y, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,d", [(147, 50, 128), (147, 50, 64),
                                     (147, 50, 256), (70, 13, 128)])
def test_flash_kernels_on_decoder_split_views_on_card(cuda, dtype, sq, sk,
                                                      d):
    """Kernels #2 and #4 on the CrossMAE decoder's layout: q a (B, Sq, H, Dh)
    view and k/v the two halves of one (B, Sk, 2, H, Dh) projection output,
    seen as (B, H, Sk, Dh) with no copy. Forward (also writing the row
    log-sum-exp) and gradients (through autograd, into the packed kv tensor)
    == the plain versions; the backward also == the plain backward that
    takes the forward's output and lse."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(4)
    b, h = 5, 2
    q_rows = torch.randn(b, sq, h, d, generator=gen).to(cuda, dtype)
    kv_rows = torch.randn(b, sk, 2, h, d, generator=gen).to(cuda, dtype)
    g = torch.randn(b, sq, h, d, generator=gen).to(cuda, dtype).transpose(1, 2)
    q_rows.requires_grad_()
    kv_rows.requires_grad_()
    q = q_rows.transpose(1, 2)
    k, v = kv_rows[:, :, 0].transpose(1, 2), kv_rows[:, :, 1].transpose(1, 2)
    assert k.stride() == (sk * 2 * h * d, d, 2 * h * d, 1)
    before = (A.flash_attention.launches, A.flash_attention.bwd_launches)
    out = A.flash_attention(q, k, v)
    d_q, d_kv = torch.autograd.grad(out, (q_rows, kv_rows), g)
    torch.cuda.synchronize()
    assert (A.flash_attention.launches,
            A.flash_attention.bwd_launches) == (before[0] + 1, before[1] + 1)
    plain = [t.detach().float() for t in (q, k, v)]
    _close_to_plain(out, A.flash_attention_ref(*plain), dtype)
    got = (d_q.transpose(1, 2), d_kv[:, :, 0].transpose(1, 2),
           d_kv[:, :, 1].transpose(1, 2))
    for x, y in zip(got, A.flash_attention_bwd_ref(*plain, None, None,
                                                   g.float())):
        _close_to_plain(x, y, dtype)
    out, lse = A._launch_flash(q.detach(), k.detach(), v.detach(), None,
                               d ** -0.5, with_lse=True)
    want_out, want_lse = A.flash_attention_lse_ref(*plain)
    _close_to_plain(out, want_out, dtype)
    _close_to_plain(lse, want_lse, torch.float32)
    for x, y in zip(got, A.flash_attention_bwd_lse_ref(
            *plain, None, None, out.float(), lse, g.float())):
        _close_to_plain(x, y, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,mask,d", [(6, 50, 3, None, 128),
                                          (4, 197, 2, "padding", 128),
                                          (6, 50, 3, "fully", 128),
                                          (4, 197, 2, "fully", 128),
                                          (4, 50, 2, "fully", 256),
                                          (2, 197, 2, "padding", 256)])
def test_packed_lse_kernels_match_plain_on_card(cuda, dtype, b, s, h, mask,
                                                d):
    """Kernel #1 writing the log-sum-exp == the plain (out, lse) forward,
    and kernel #3 from that out and lse == the plain backward that takes
    them, at S <= 64 (one backward kernel) and above (two), a row whose keys
    are all masked included, and at Dh 256 (the scalar bodies); each call
    adds exactly one to its launch count."""
    _check_packed_lse_kernels(cuda, dtype, b, s, h, mask, d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h", [(6, 50, 4), (4, 197, 4)])
def test_packed_lse_kernels_match_plain_on_card_head_dim_64(cuda, dtype, b, s,
                                                            h):
    """The same at head dim 64 (a ViT-B head), with a padding mask, where
    the bf16 bodies are their own template instances (and the one-kernel
    backward at S <= 64 lays out its shared memory differently); #3 also
    == the plain backward that recomputes the statistics."""
    d_qkv, (qkv, kv, g) = _check_packed_lse_kernels(cuda, dtype, b, s, h,
                                                    "padding", 64)
    _close_to_plain(d_qkv, A.qkv_packed_attention_bwd_ref(
        qkv.float(), kv, h, None, g.float()), dtype)


def _check_packed_lse_kernels(cuda, dtype, b, s, h, mask, d):
    """#1 with lse and #3 from it against the plain versions that take
    them; returns #3's d_qkv and its (qkv, mask, d_out) inputs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(6)
    qkv = torch.randn(b, s, 3 * h * d, generator=gen).to(cuda, dtype)
    g = torch.randn(b, s, h * d, generator=gen).to(cuda, dtype)
    kv = None
    if mask is not None:
        kv = (torch.rand(b, s, generator=gen) > 0.2).float().to(cuda)
        kv[:, 0] = 1
        if mask == "fully":
            kv[1] = 0
    before = (A.qkv_packed_attention.launches,
              A.qkv_packed_attention.bwd_launches)
    out, lse = A._launch_packed(qkv, kv, h, d ** -0.5, with_lse=True)
    d_qkv = A._launch_packed_bwd(qkv, kv, h, d ** -0.5, out, lse, g)
    torch.cuda.synchronize()
    assert (A.qkv_packed_attention.launches,
            A.qkv_packed_attention.bwd_launches) == (before[0] + 1,
                                                     before[1] + 1)
    want_out, want_lse = A.qkv_packed_attention_lse_ref(qkv.float(), kv, h)
    _close_to_plain(out, want_out, dtype)
    _close_to_plain(lse, want_lse, torch.float32)
    want = A.qkv_packed_attention_bwd_lse_ref(qkv.float(), kv, h, None,
                                              out.float(), lse, g.float())
    _close_to_plain(d_qkv, want, dtype)
    return d_qkv, (qkv, kv, g)
