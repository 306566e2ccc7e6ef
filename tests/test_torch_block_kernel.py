"""The fused block-stack wrappers (mae_clip_torch.ops.block_kernel), their
CUDA kernels (#6 forward, #7 backward) and the ``fused_blocks`` gate.

On the CPU: the explicit backward ``fused_block_stack_bwd_ref`` against
torch.autograd through the plain forward ``fused_block_stack_ref`` (fp32,
atol 1e-5 / rtol 1e-4: the same math summed in another order), the plain
backward from the plain forward's state against the recomputing one (bit
for bit), when the autograd wrappers keep a state, the gate's decisions,
and that the wrappers take the plain versions for CPU tensors. On a CUDA
card (tests marked ``cuda``): #6 against its plain version on the same
inputs, its state against the plain block's on the same block input, #7
from #6's state against the plain backward from the same state, fp32
within 1e-4 * max(1, max |plain|) and bf16 within 2e-2 * max(1, max
|plain|) (the kernels sum in another order, and in bf16 one rounding that
goes the other way travels through the later blocks), for the output, dq0,
dkv and all 16 weight gradients; #6's output the same bits with and
without a state; the launch and state-allocation counters. This file
imports neither JAX nor the JAX package, so the card-only tests run where
those are not installed
(``pytest tests/test_torch_block_kernel.py -m cuda --noconftest``).
"""

import pytest
import torch

import chip_smoke
from mae_clip_torch.models.layers import init_weights
from mae_clip_torch.models.vit import ViTConfig, ViTEncoder, use_fused_blocks
from mae_clip_torch.ops import block_kernel as BK
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# (B, Sq, Sk, D, H, F, L, cross): the smallest legal width at odd lengths
# (Sq and Sk not multiples of 16 or 64), self and cross.
SMALL = [(2, 9, 5, 128, 1, 256, 2, True), (2, 9, 9, 128, 1, 256, 2, False)]
# The flagship stacks cut to two blocks: the ViT-S/16 encoder at S=50 and at
# S=197 (serving), the CrossMAE decoder (147 queries on 50 tokens).
CARD = SMALL + [(8, 50, 50, 384, 3, 1536, 2, False),
                (4, 197, 197, 384, 3, 1536, 1, False),
                (8, 147, 50, 256, 2, 1024, 2, True),
                # Heads of 256 (the attention bodies' scalar instances).
                (2, 37, 37, 512, 2, 1024, 2, False),
                (2, 70, 13, 512, 2, 1024, 2, True),
                # Heads of 64 (the tensor-core bodies' narrow instances).
                (2, 50, 50, 128, 2, 256, 2, False),
                (2, 70, 13, 128, 2, 256, 2, True)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(shape, seed, device="cpu", dtype=torch.float32):
    """q0, kv (kv = q0 in self mode) and stacked weights (torch layout),
    weights 0.05 * normal, LN scales 1 + 0.05 * normal."""
    b, sq, sk, d, _, f, n, cross = shape
    gen = torch.Generator().manual_seed(seed)

    def s(*sh):
        return torch.randn(*sh, generator=gen) * 0.05

    w = {"ln1_g": 1 + s(n, d), "ln1_b": s(n, d), "lnkv_g": 1 + s(n, d),
         "lnkv_b": s(n, d), "wq": s(n, d, d), "bq": s(n, d),
         "wkv": s(n, 2 * d, d), "bkv": s(n, 2 * d), "wproj": s(n, d, d),
         "bproj": s(n, d), "ln2_g": 1 + s(n, d), "ln2_b": s(n, d),
         "wfc1": s(n, f, d), "bfc1": s(n, f), "wfc2": s(n, d, f),
         "bfc2": s(n, d)}
    q0 = torch.randn(b, sq, d, generator=gen)
    kv = torch.randn(b, sk, d, generator=gen) if cross else q0
    dout = torch.randn(b, sq, d, generator=gen)
    cast = dict(device=device, dtype=dtype)
    return (q0.to(**cast), kv.to(**cast),
            {k: v.to(**cast) for k, v in w.items()}, dout.to(**cast))


@pytest.mark.parametrize("gelu", ["tanh", "erf"])
@pytest.mark.parametrize("shape", SMALL, ids=["cross", "self"])
def test_explicit_backward_matches_autograd(shape, gelu):
    """fused_block_stack_bwd_ref (explicit math) against autograd through
    fused_block_stack_ref, fp32, with a gradient in every output."""
    q0, kv, w, dout = _inputs(shape, 0)
    cross, h = shape[-1], shape[4]
    leaves = [q0.clone().requires_grad_()]
    kv_in = leaves[0]
    if cross:
        kv_in = kv.clone().requires_grad_()
        leaves.append(kv_in)
    ws = {k: v.clone().requires_grad_() for k, v in w.items()}
    out, qstack = BK.fused_block_stack_ref(leaves[0], kv_in, ws, h, gelu,
                                           cross)
    want = torch.autograd.grad(out, leaves + list(ws.values()), dout,
                               allow_unused=True)
    dq0, dkv, dw = BK.fused_block_stack_bwd_ref(qstack.detach(), kv, w,
                                                dout, h, gelu, cross)
    tol = dict(atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(dq0, want[0], **tol)
    if cross:
        torch.testing.assert_close(dkv, want[1], **tol)
    else:
        assert torch.equal(dkv, torch.zeros_like(kv))
    for k, g in zip(ws, want[len(leaves):]):
        if g is None:  # lnkv in self mode
            assert not cross and torch.equal(dw[k], torch.zeros_like(w[k]))
        else:
            torch.testing.assert_close(dw[k], g, **tol, msg=k)


@pytest.mark.parametrize("shape", SMALL, ids=["cross", "self"])
def test_row_sum_from_ctx_matches_row_sum_from_p(shape):
    """The explicit backward with the attention's row sum taken as
    rowsum(dO * ctx), as kernel #7's bf16 body takes it, against the TPU's
    rowsum(P * dP): equal in exact arithmetic, fp32 atol 1e-5 / rtol 1e-4."""
    q0, kv, w, dout = _inputs(shape, 1)
    cross, h = shape[-1], shape[4]
    qstack = BK.fused_block_stack_ref(q0, kv, w, h, "tanh", cross)[1]
    want = BK.fused_block_stack_bwd_ref(qstack, kv, w, dout, h, "tanh", cross)
    got = BK.fused_block_stack_bwd_ref(qstack, kv, w, dout, h, "tanh", cross,
                                       delta_from_ctx=True)
    tol = dict(atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(got[:2], want[:2], **tol)
    for k in BK.W_KEYS:
        torch.testing.assert_close(got[2][k], want[2][k], **tol, msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", SMALL, ids=["cross", "self"])
def test_plain_backward_from_state_matches_recompute(shape, dtype):
    """The plain backward from the plain forward's state against the plain
    backward that recomputes each block from qstack: the same bits (dq0,
    dkv, the 16 weight gradients). The state holds STATE_KEYS per block,
    kvh and the LNkv statistics only in cross mode."""
    q0, kv, w, dout = _inputs(shape, 6, dtype=dtype)
    cross, h = shape[-1], shape[4]
    _, qstack, state = BK.fused_block_stack_ref(q0, kv, w, h, "tanh", cross,
                                                keep_state=True)
    assert len(state) == shape[6]
    for st in state:
        assert tuple(st) == BK.STATE_KEYS
        for k in ("kvh", "meankv", "rstdkv"):
            assert (st[k] is not None) == cross, k
        assert st["a1"].dtype == dtype and st["lse"].dtype == torch.float32
        assert st["lse"].shape == (shape[0], h, shape[1])
    got = BK.fused_block_stack_bwd_ref(qstack, kv, w, dout, h, "tanh", cross,
                                       state=state)
    want = BK.fused_block_stack_bwd_ref(qstack, kv, w, dout, h, "tanh", cross)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for k in BK.W_KEYS:
        assert torch.equal(got[2][k], want[2][k]), k


def test_state_kept_only_when_a_gradient_is_wanted(monkeypatch):
    """fused_block_stack asks its forward for the state only with grad mode
    on and an input that needs a gradient, and its backward (through
    autograd) gives the plain recomputing backward's bits; 'fwd' never asks
    for one."""
    shape = SMALL[0]
    q0, kv, w, dout = _inputs(shape, 7)
    kept = []
    real = BK._stack_forward
    monkeypatch.setattr(BK, "_stack_forward",
                        lambda *a: kept.append(a[6:] == (True,)) or real(*a))
    leaves = [q0.clone().requires_grad_(), kv.clone().requires_grad_()]
    ws = {k: v.clone().requires_grad_() for k, v in w.items()}
    with torch.no_grad():
        BK.fused_block_stack(leaves[0], leaves[1], ws, 1, "tanh")
    with torch.inference_mode():
        BK.fused_block_stack(leaves[0], leaves[1], ws, 1, "tanh")
    BK.fused_block_stack(q0, kv, w, 1, "tanh")  # nothing needs a gradient
    BK.fused_block_stack_fwd_plain_bwd(leaves[0], leaves[1], ws, 1, "tanh")
    assert kept == [False] * 4
    out = BK.fused_block_stack(leaves[0], leaves[1], ws, 1, "tanh")
    assert kept == [False] * 4 + [True]
    got = torch.autograd.grad(out, leaves + list(ws.values()), dout)
    qstack = BK.fused_block_stack_ref(q0, kv, w, 1, "tanh")[1]
    want_q, want_kv, want_w = BK.fused_block_stack_bwd_ref(
        qstack, kv, w, dout, 1, "tanh")
    assert torch.equal(got[0], want_q) and torch.equal(got[1], want_kv)
    for k, g in zip(ws, got[2:]):
        assert torch.equal(g, want_w[k]), k


@pytest.mark.parametrize("fn", ["fused_block_stack",
                                "fused_block_stack_fwd_plain_bwd"])
def test_cpu_wrappers_take_the_plain_versions(fn):
    """On CPU tensors both wrappers give the plain forward's output and
    launch nothing; in self mode kv gets no gradient of its own."""
    shape = SMALL[1]
    q0, kv, w, dout = _inputs(shape, 1)
    before = (BK.fused_block_stack.launches,
              BK.fused_block_stack.bwd_launches)
    x = q0.clone().requires_grad_()
    out = getattr(BK, fn)(x, x, w, 1, "tanh", cross=False)
    torch.testing.assert_close(
        out, BK.fused_block_stack_ref(q0, q0, w, 1, "tanh", False)[0],
        rtol=0, atol=0)
    out.backward(dout)
    assert x.grad is not None and x.grad.shape == x.shape
    assert (BK.fused_block_stack.launches,
            BK.fused_block_stack.bwd_launches) == before


def _gemm_operands(pair, m, n, k, seed):
    """CPU bf16 operands of one product of the stacks' GEMM body."""
    gen = torch.Generator().manual_seed(seed)
    return chip_smoke._gemm_inputs(gen, pair, m, n, k,
                                   device=torch.device("cpu"))


@pytest.mark.parametrize("mode", BK.GEMM_MODES)
def test_gemm_body_ref_is_the_stacks_math(mode):
    """The GEMM body's plain version gives the plain stacks' own values:
    each forward product as ``_proj`` (plus the residual, the GELU), each
    input gradient as ``_mm_back`` with its epilogue, bit for bit; the
    weight gradients' split partials sum to ``_dweight`` (fp32, atol
    1e-4 / rtol 1e-5: the splits sum in another order) and hold zeros in a
    split past K; and the wrapper takes the plain version on the CPU."""
    pair = next(p for p in BK.GEMM_PAIRS if p[2] == mode)
    m, n, k = 37, 24, 100  # splits of 64 rows: 64, 36 and none
    splits = 3
    x = _gemm_operands(pair, m, n, k, 21)
    a, b, dt = x["a"], x["b"], torch.bfloat16
    got = BK.gemm_body_ref(a, b, mode, pair[0] == "km", pair[1] == "kn",
                           x["bias"], x["res"], x["aux"], x["outf"], "tanh",
                           splits if mode == "partial" else 1)
    assert set(got) == set(BK.GEMM_OUTPUTS[mode])
    if mode == "partial":
        assert got["outf"].shape == (splits, m, n)
        torch.testing.assert_close(got["outf"].sum(0), BK._dweight(a, b),
                                   atol=1e-4, rtol=1e-5)
        assert not got["outf"][2].any()  # the third split starts past K
    else:
        want = {"bias": lambda: {"out": BK._proj(a, b, x["bias"], dt)},
                "bias_res": lambda: {"out": x["res"] + BK._proj(
                    a, b, x["bias"], dt)},
                "bias_gelu": lambda: {
                    "out": BK._proj(a, b, x["bias"], dt),
                    "out2": BK._gelu(BK._proj(a, b, x["bias"], dt).float(),
                                     "tanh").to(dt)},
                "gelu_grad": lambda: {
                    "outf": BK._mm_back(a, b) * BK._gelu_grad(
                        x["aux"].float(), "tanh"),
                    "out": (BK._mm_back(a, b) * BK._gelu_grad(
                        x["aux"].float(), "tanh")).to(dt)},
                "f32": lambda: {"outf": BK._mm_back(a, b)},
                "f32_add": lambda: {"outf": x["outf"] + BK._mm_back(a, b)},
                "round": lambda: {"out": BK._mm_back(a, b).to(dt)}}[mode]()
        for name, y in want.items():
            assert torch.equal(got[name], y), name
    on_cpu = BK.gemm_body(a, b, mode, pair[0] == "km", pair[1] == "kn",
                          x["bias"], x["res"], x["aux"], x["outf"], "tanh",
                          splits if mode == "partial" else 1)
    for name in got:
        assert torch.equal(on_cpu[name], got[name]), name


def test_gemm_body_launches_only_the_stacks_pairs():
    """A (layout, epilogue) pair that no stack launches is refused before
    any library is loaded; the pairs cover every epilogue once, in
    block_common.cuh's order, and the breakdown names them in that order."""
    a = torch.zeros(8, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="launch no product"):
        BK._launch_gemm(a, a, "bias", a_km=True)
    assert sorted(p[2] for p in BK.GEMM_PAIRS) == sorted(BK.GEMM_MODES)
    assert len(chip_smoke.EPILOGUES) == len(BK.GEMM_MODES)


@pytest.mark.parametrize("pair", list(BK.GEMM_PAIRS),
                         ids=[",".join(p) for p in BK.GEMM_PAIRS])
def test_breakdown_groups_by_layout_and_epilogue(pair):
    """chip_smoke's launch breakdown maps the wgmma body's demangled names
    to groups by (layout, epilogue), and only the forward products to a
    forward group (#7's breakdown must hold none); a GEMM body it does not
    know, such as the old mma.sync one, falls in a group that the smoke run
    fails on, as the scalar body's does."""
    mode = BK.GEMM_MODES.index(pair[2])
    flags = ["true" if pair[0] == "km" else "false",
             "true" if pair[1] == "kn" else "false"]
    name = ("void (anonymous namespace)::gemm_wgmma_kernel<"
            f"{flags[0]}, {flags[1]}, {mode}>(CUtensorMap_st, "
            "CUtensorMap_st, (anonymous namespace)::Gemm<__nv_bfloat16>, "
            "int, int, int)")
    group = chip_smoke._kernel_group(name)
    assert group == (f"GEMM wgmma<{pair[0]},{pair[1]},"
                     f"{chip_smoke.EPILOGUES[mode]}>")
    assert group.startswith(chip_smoke.FORWARD_GROUPS) == (pair[:2] ==
                                                           ("mk", "nk"))
    assert not group.startswith(chip_smoke.OFF_BODY_GROUPS)
    for other in (f"void (anonymous namespace)::gemm_mma_kernel<"
                  f"{flags[0]}, {flags[1]}, {mode}>((anonymous namespace)::"
                  "Gemm<__nv_bfloat16>)",
                  "void (anonymous namespace)::gemm_scalar_kernel<"
                  "__nv_bfloat16>((anonymous namespace)::Gemm<"
                  "__nv_bfloat16>)"):
        assert chip_smoke._kernel_group(other).startswith(
            chip_smoke.OFF_BODY_GROUPS)


def test_breakdown_names_the_gathered_body():
    """The GEMM body's instances carry a fourth template argument, the
    gathered A of kernel #5: the stacks' instances (false) keep their
    groups, and #5's (true) is the group that phase 2 requires of a bf16
    #5 call, which is neither a forward group of the stacks nor off-body;
    #5's old mma.sync and scalar bodies are not it."""
    stem = ("void (anonymous namespace)::gemm_wgmma_kernel<false, false, 0, "
            "{}>(CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::"
            "Gemm<__nv_bfloat16>, int, int, int)")
    assert chip_smoke._kernel_group(stem.format("false")) == \
        "GEMM wgmma<mk,nk,bias>"
    group = chip_smoke._kernel_group(stem.format("true"))
    assert group == chip_smoke.PATCH_EMBED_BODY == "GEMM wgmma<gather,nk,bias>"
    assert not group.startswith(chip_smoke.FORWARD_GROUPS)
    assert not group.startswith(chip_smoke.OFF_BODY_GROUPS)
    for old in ("void (anonymous namespace)::embed_mma_kernel((anonymous "
                "namespace)::Params<__nv_bfloat16>)",
                "void (anonymous namespace)::embed_kernel<__nv_bfloat16>("
                "(anonymous namespace)::Params<__nv_bfloat16>)"):
        assert chip_smoke._kernel_group(old) != chip_smoke.PATCH_EMBED_BODY


def test_use_fused_blocks_gate():
    """'on'/'fwd' engage at heads of a multiple of 128, dropout 0 and a
    known GELU; 'off' and 'auto' never do; an unknown value raises."""
    flagship = ViTConfig(dim=384, n_heads=3, gelu="tanh")
    assert use_fused_blocks("on", flagship)
    assert use_fused_blocks("fwd", flagship)
    assert not use_fused_blocks("off", flagship)
    assert not use_fused_blocks("auto", flagship)
    assert not use_fused_blocks("on", ViTConfig(dim=384, n_heads=6))  # Dh 64
    assert not use_fused_blocks("on", ViTConfig(dim=384, n_heads=3,
                                                dropout=0.1))
    assert not use_fused_blocks("on", ViTConfig(dim=384, n_heads=3,
                                                gelu="relu"))
    with pytest.raises(ValueError, match="block_impl"):
        use_fused_blocks("always", flagship)


@pytest.mark.parametrize("block_impl", ["on", "fwd"])
def test_vit_encoder_fused_matches_per_block(block_impl, monkeypatch):
    """ViTEncoder (the non-MAE image tower) with a fused block_impl against
    'off' on the same weights, fp32 on the CPU: the pooled feature (atol
    2e-5 / rtol 1e-4) and the input and weight gradients (1e-3 / 1e-3), as
    the JAX package's test_vit_encoder_fused_matches_xla holds its own; and
    the blocks run as one stack."""
    cfg = ViTConfig(image_size=32, patch_size=8, dim=128, depth=2, n_heads=1,
                    mlp_ratio=2.0, pos_embed="sincos", gelu="tanh")
    models = [ViTEncoder(cfg, block_impl=impl) for impl in ("off",
                                                            block_impl)]
    init_weights(models[0], torch.Generator().manual_seed(0))
    models[1].load_state_dict(models[0].state_dict())
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    stacks = []
    real = BK._stack_forward
    monkeypatch.setattr(BK, "_stack_forward",
                        lambda *a: stacks.append(a[5]) or real(*a))
    outs, grads = [], []
    for model in models:
        xi = x.clone().requires_grad_()
        out = model(xi)
        (out ** 2).sum().backward()
        outs.append(out.detach())
        grads.append([xi.grad] + [p.grad for p in model.parameters()])
    assert stacks == [False]
    torch.testing.assert_close(outs[1], outs[0], atol=2e-5, rtol=1e-4)
    for a, b in zip(grads[1], grads[0]):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _tol(want: torch.Tensor, dtype) -> float:
    scale = max(1.0, float(want.abs().max()))
    return (1e-4 if dtype == torch.float32 else 2e-2) * scale


def _assert_close(got, want, dtype, what):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all(), what
    err = float((got - want).abs().max())
    assert err <= _tol(want, dtype), (what, err, _tol(want, dtype))


FP32, BF16 = torch.float32, torch.bfloat16
# Every shape in fp32 and bf16 with tanh; erf at the odd shapes in both
# types and at the flagship shapes in bf16.
CARD_CASES = ([(s, "tanh", dt) for s in CARD for dt in (FP32, BF16)]
              + [(s, "erf", dt) for s in SMALL for dt in (FP32, BF16)]
              + [(s, "erf", BF16) for s in CARD[2:]])
CARD_IDS = [f"{name}-{gelu}-{str(dt)[6:]}" for (s, gelu, dt) in CARD_CASES
            for name in [("odd-cross", "odd-self", "encoder", "serving",
                          "decoder", "wide-self", "wide-cross",
                          "narrow-self", "narrow-cross")[CARD.index(s)]]]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,gelu,dtype", CARD_CASES, ids=CARD_IDS)
def test_kernels_match_plain_on_card(cuda, shape, gelu, dtype):
    """#6 against the plain forward on the same inputs (output, qstack), the
    same bits with a state buffer as without, and its state against the
    plain block's on the same block input; #7 from #6's qstack and state
    against the plain backward from the same (dq0, dkv, the 16 weight
    gradients)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q0, kv, w, dout = _inputs(shape, 2, cuda, dtype)
    cross, h = shape[-1], shape[4]
    out, qstack, state = BK._launch_fwd(q0, kv, w, h, gelu, cross,
                                        keep_state=True)
    bare_out, bare_qstack = BK._launch_fwd(q0, kv, w, h, gelu, cross)
    want_out, want_qstack = BK.fused_block_stack_ref(q0, kv, w, h, gelu,
                                                     cross)
    torch.cuda.synchronize()
    assert torch.equal(out, bare_out) and torch.equal(qstack, bare_qstack)
    _assert_close(out, want_out, dtype, "out")
    _assert_close(qstack, want_qstack, dtype, "qstack")
    views = BK.state_views(state, qstack, kv, w, h, cross)
    for l, st in enumerate(views):
        want_st = BK._block(qstack[l], kv, {k: v[l] for k, v in w.items()},
                            h, gelu, cross)[1]
        for k in BK.STATE_KEYS:
            assert (st[k] is None) == (want_st[k] is None), k
            if st[k] is not None:
                _assert_close(st[k], want_st[k], dtype, f"block {l} {k}")
    got = BK._launch_bwd(qstack, kv, w, dout, state, h, gelu, cross)
    want = BK.fused_block_stack_bwd_ref(qstack, kv, w, dout, h, gelu, cross,
                                        state=views)
    torch.cuda.synchronize()
    _assert_close(got[0], want[0], dtype, "dq0")
    if cross:
        _assert_close(got[1], want[1], dtype, "dkv")
    for k in BK.W_KEYS:
        _assert_close(got[2][k], want[2][k], dtype, k)


@pytest.mark.cuda
def test_autograd_and_launch_counters_on_card(cuda):
    """One pass through autograd (a cross stack, bf16): one #6 and one #7
    launch and one state buffer, gradients as the plain backward's; 'fwd'
    launches #6 and no #7, and allocates no state."""
    shape = CARD[6]
    q0, kv, w, dout = _inputs(shape, 3, cuda, torch.bfloat16)
    xs = [t.clone().requires_grad_() for t in (q0, kv)]
    ws = {k: v.clone().requires_grad_() for k, v in w.items()}
    BK.fused_block_stack.launches = BK.fused_block_stack.bwd_launches = 0
    BK.fused_block_stack.state_allocs = 0
    out = BK.fused_block_stack(xs[0], xs[1], ws, 2, "tanh", cross=True)
    grads = torch.autograd.grad(out, xs + list(ws.values()), dout)
    assert (BK.fused_block_stack.launches, BK.fused_block_stack.bwd_launches,
            BK.fused_block_stack.state_allocs) == (1, 1, 1)
    want_q, want_kv, want_w = BK.fused_block_stack_bwd_ref(
        BK.fused_block_stack_ref(q0, kv, w, 2, "tanh", True)[1], kv, w, dout,
        2, "tanh", True)
    _assert_close(grads[0], want_q, torch.bfloat16, "dq0")
    _assert_close(grads[1], want_kv, torch.bfloat16, "dkv")
    for k, g in zip(ws, grads[2:]):
        _assert_close(g, want_w[k], torch.bfloat16, k)
    out = BK.fused_block_stack_fwd_plain_bwd(xs[0], xs[1], ws, 2, "tanh",
                                             cross=True)
    torch.autograd.grad(out, xs + list(ws.values()), dout)
    assert (BK.fused_block_stack.launches, BK.fused_block_stack.bwd_launches,
            BK.fused_block_stack.state_allocs) == (2, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [CARD[2], CARD[4]], ids=["self", "cross"])
def test_no_state_without_a_gradient_on_card(cuda, shape):
    """#6 allocates and writes no state under torch.no_grad() or
    torch.inference_mode(), on inputs that need no gradient, or with
    fused_blocks='fwd' (fused_block_stack_fwd_plain_bwd), forward and
    backward; it allocates one where a gradient is wanted. Counted by the
    wrapper's state allocations."""
    q0, kv, w, dout = _inputs(shape, 8, cuda, torch.bfloat16)
    cross, h = shape[-1], shape[4]
    xs = [t.clone().requires_grad_() for t in (q0, kv)]
    ws = {k: v.clone().requires_grad_() for k, v in w.items()}
    BK.fused_block_stack.state_allocs = BK.fused_block_stack.launches = 0
    with torch.no_grad():
        BK.fused_block_stack(xs[0], xs[1], ws, h, "tanh", cross)
    with torch.inference_mode():
        BK.fused_block_stack(xs[0], xs[1], ws, h, "tanh", cross)
    BK.fused_block_stack(q0, kv, w, h, "tanh", cross)
    out = BK.fused_block_stack_fwd_plain_bwd(xs[0], xs[1], ws, h, "tanh",
                                             cross)
    torch.autograd.grad(out, xs[:1 + cross] + list(ws.values()), dout)
    assert (BK.fused_block_stack.launches,
            BK.fused_block_stack.state_allocs) == (4, 0)
    BK.fused_block_stack(xs[0], xs[1], ws, h, "tanh", cross)
    assert BK.fused_block_stack.state_allocs == 1


@pytest.mark.cuda
def test_backward_without_state_raises_on_card(cuda):
    """#7 reads #6's state and has no other way: without it, or with a
    buffer of the wrong size, its wrapper raises rather than recompute."""
    shape = CARD[0]
    q0, kv, w, dout = _inputs(shape, 9, cuda, torch.bfloat16)
    _, qstack, state = BK._launch_fwd(q0, kv, w, 1, "tanh", True,
                                      keep_state=True)
    for bad in (None, state[:-256]):
        with pytest.raises(ValueError, match="keep_state=True"):
            BK.fused_block_stack_bwd(qstack, kv, w, dout, bad, 1, "tanh")


@pytest.mark.cuda
def test_wide_heads_raise_on_card(cuda):
    """Heads wider than the attention bodies take (256) raise on the card
    rather than run another program."""
    shape = (2, 9, 5, 512, 1, 256, 1, True)
    q0, kv, w, _ = _inputs(shape, 4, cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="Dh <= 256"):
        BK.fused_block_stack(q0, kv, w, 1, "tanh", cross=True)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", list(BK.GEMM_PAIRS),
                         ids=[",".join(p) for p in BK.GEMM_PAIRS])
def test_gemm_body_matches_reference_on_card(cuda, pair):
    """Each template of the stacks' GEMM body (a (layout, epilogue) pair the
    stacks launch) against the fp32 product of the same
    bf16 operands with the epilogue in torch, at a cut of each main product
    (1,024 rows, the stacks' N and K) and at M 200, N 24, K 40 (3 splits
    for the partials): fp32 outputs within 1e-3 * max(1, max |ref|), bf16
    ones within one bf16 step per rounding of the reference rounded the
    same way, plus the fp32 sums' order (chip_smoke.check_gemm_case)."""
    gen = torch.Generator().manual_seed(15)
    for shape in chip_smoke.gemm_check_shapes(pair):
        assert chip_smoke.check_gemm_case(pair, *shape, gen) <= 1.0


@pytest.mark.cuda
def test_gemm_body_refuses_what_it_does_not_take_on_card(cuda):
    """A product the tensor-core body does not take raises rather than run
    another body: rows of 36 elements (not 16-byte multiples), and a
    contiguous residual whose base is 4 bytes off a 16-byte boundary (the
    epilogue reads it in 16-byte chunks)."""
    a = torch.randn(64, 36, device=cuda).to(torch.bfloat16)
    b = torch.randn(32, 36, device=cuda).to(torch.bfloat16)
    bias = torch.zeros(32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="gemm body"):
        BK.gemm_body(a, b, "bias", bias=bias)
    a = torch.randn(64, 32, device=cuda).to(torch.bfloat16)
    b = torch.randn(32, 32, device=cuda).to(torch.bfloat16)
    res = torch.zeros(64 * 32 + 2, device=cuda,
                      dtype=torch.bfloat16)[2:].view(64, 32)
    assert res.is_contiguous() and res.data_ptr() % 16 == 4
    with pytest.raises(RuntimeError, match="gemm body"):
        BK.gemm_body(a, b, "bias_res", bias=bias, res=res)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [CARD[2], CARD[4]], ids=["self", "cross"])
def test_backward_is_deterministic_on_card(cuda, shape):
    """Two calls of #7 on the same qstack, state and dout give the same
    bits: the weight gradients' split partials are summed in a fixed order,
    with no atomics."""
    q0, kv, w, dout = _inputs(shape, 10, cuda, torch.bfloat16)
    cross, h = shape[-1], shape[4]
    _, qstack, state = BK._launch_fwd(q0, kv, w, h, "tanh", cross,
                                      keep_state=True)
    first = BK._launch_bwd(qstack, kv, w, dout, state, h, "tanh", cross)
    second = BK._launch_bwd(qstack, kv, w, dout, state, h, "tanh", cross)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    if cross:
        assert torch.equal(first[1], second[1])
    for k in BK.W_KEYS:
        assert torch.equal(first[2][k], second[2][k]), k
