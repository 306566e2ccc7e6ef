"""The port's ResNet-50 tower (mae_clip_torch.models.resnet) against the JAX
package's, and the converter's ResNet layout.

The tower is cut to one bottleneck a stage, widths (4, 8, 16, 32), on
32x32 images; its weights and BatchNorm statistics are JAX's parameter
tree (``jax.eval_shape`` of ``init``: no compile) filled from a numpy seed
and converted through the port's converter. Each batch ends with a
padded row (zeros), which counts in the batch statistics on both sides.

Tolerances. In fp32 the JAX reference runs in float64
(``jax_enable_x64`` around the call): JAX's CPU backend sums each
channel's statistics one element after another in fp32, which is off the
exact sum by ~n * 2^-24 of its size, and flax's one-pass variance
``E[x^2] - E[x]^2`` turns that into a share of the variance as large as
(mean / std)^2 times it. Against JAX's own fp32 the port (whose sums are
blocked) differs by up to 7e-5 of outputs of ~4 for that reason alone;
against the float64 reference it holds outputs within 1e-4 (measured
1.7e-5) and the updated statistics within 1e-6 (measured 3.6e-7), which
no semantic slip (torch's unbiased update, another momentum or eps)
would meet. In bf16 the port rounds every convolution and BatchNorm
output to bf16 (XLA may keep some in fp32: excess precision is allowed on
the CPU); eval-mode outputs agree within 4e-2 * max(1, |x|). In train mode
the last stage normalises 6 values a channel (B x 1 x 1), so one bf16
rounding moves the outputs by a share of |x| / std: against a float64 run
both bf16 towers are off by 0.21-0.37 of outputs ~4 (port 1.2-1.7x JAX's;
three seeds measured), and the test holds port against JAX within
0.1 * max(1, |x|), the statistics within 2e-2 * max(1, |x|). Port
against JAX in train mode measured 0.068 / 0.079 / 0.144 of max(1, |x|)
at image seeds 2 / 3 / 4 (the test's is 2), the statistics 2.8e-3 /
3.0e-3 / 3.6e-3, the same with the port's earlier BatchNorm written out
in torch ops as with torch's kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from mae_clip_tpu import config as jax_config
from mae_clip_tpu.models import clip as jax_clip
from mae_clip_tpu.models import distilbert as jax_distilbert
from mae_clip_tpu.models import resnet as jax_resnet
from mae_clip_torch import config as torch_config
from mae_clip_torch.interop.from_jax import _flatten, state_dict_from_flax
from mae_clip_torch.models import CLIPModel, DistilBertConfig
from mae_clip_torch.models.layers import Conv2d
from mae_clip_torch.models.resnet import ResNet
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPE = ((1, 1, 1, 1), (4, 8, 16, 32))
B, SIZE = 6, 32


def _images(seed: int) -> np.ndarray:
    x = np.random.default_rng(seed).normal(size=(B, SIZE, SIZE, 3))
    x[-1] = 0.0                       # the padded row
    return x.astype(np.float32)


def _fill(rng):
    """Kernels normal / sqrt(fan_in), BatchNorm scales 1 + 0.1 normal,
    biases and running means 0.1 normal, running variances 1 + 0.5 |normal|
    (so eval mode reads statistics that are not the initial ones)."""
    def fill(path, leaf):
        name = str(path[-1].key)
        v = rng.normal(size=leaf.shape).astype(np.float32)
        if name == "kernel":
            return v / np.sqrt(np.prod(leaf.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * v
        if name == "var":
            return 1.0 + 0.5 * np.abs(v)
        return 0.1 * v
    return fill


@pytest.fixture(scope="module")
def tower():
    """JAX's ResNet (no dtype: it computes in its inputs' dtype), its
    seeded variables, and the port's state_dict of them."""
    jm = jax_resnet.ResNet(stage_sizes=SHAPE[0], widths=SHAPE[1])
    shapes = jax.eval_shape(lambda r: jm.init(r, jnp.zeros((1, SIZE, SIZE,
                                                             3))),
                            jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map_with_path(
        _fill(np.random.default_rng(0)), shapes)
    sd = {}
    _flatten(variables["batch_stats"], "", sd)
    _flatten(variables["params"], "", sd)
    return jm, variables, sd


def _port(sd, dtype=torch.float32) -> ResNet:
    model = ResNet(SHAPE[0], SHAPE[1], dtype)
    model.load_state_dict(sd, strict=True)
    return model


def _stats(sd) -> dict:
    return {k: v for k, v in sd.items() if k.endswith(("running_mean",
                                                       "running_var"))}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnet_fp32_matches_jax(tower, train):
    """Outputs and, in train mode, the updated running statistics, against
    JAX's ``ResNet.apply(..., mutable=['batch_stats'])`` in float64."""
    jm, variables, sd = tower
    x = _images(1)
    model = _port(sd)
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=train)
    jax.config.update("jax_enable_x64", True)
    try:
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     variables)
        out, upd = jax.jit(lambda v, x: jm.apply(
            v, x, train=train, mutable=["batch_stats"]))(
                v64, jnp.asarray(x, jnp.float64))
        out, upd = np.asarray(out), jax.tree_util.tree_map(np.asarray, upd)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert got.dtype == torch.float32 and got.shape == (B, 128)
    np.testing.assert_allclose(got.numpy(), out, atol=1e-4, rtol=1e-4)
    want = {}
    _flatten(upd["batch_stats"], "", want)
    stats = _stats(model.state_dict())
    assert set(stats) == set(_stats(want))
    moved = 0.0
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-6,
                                   rtol=1e-6, err_msg=k)
        moved += float((v - sd[k]).abs().sum())
    assert (moved > 0) == train
    tracked = {int(v) for k, v in model.state_dict().items()
               if k.endswith("num_batches_tracked")}
    assert tracked == {int(train)}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnet_bf16_matches_jax(tower, train):
    """bf16 towers (flax ``dtype=bfloat16``, the port's compute dtype):
    fp32 statistics, one rounding per output; outputs within 4e-2 (eval)
    or 0.1 (train) * max(1, |x|), the statistics within 2e-2 * max(1, |x|)
    (module docstring)."""
    _, variables, sd = tower
    jm = jax_resnet.ResNet(stage_sizes=SHAPE[0], widths=SHAPE[1],
                           dtype=jnp.bfloat16)
    x = _images(2)
    out, upd = jax.jit(lambda v, x: jm.apply(
        v, x, train=train, mutable=["batch_stats"]))(variables,
                                                     jnp.asarray(x))
    model = _port(sd, torch.bfloat16)
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=train)
    assert got.dtype == torch.bfloat16
    want = np.asarray(out.astype(jnp.float32))
    limit = (0.1 if train else 4e-2) * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, atol=limit)
    stats = {}
    _flatten(jax.tree_util.tree_map(np.asarray, upd["batch_stats"]), "",
             stats)
    for k, v in _stats(model.state_dict()).items():
        np.testing.assert_allclose(v.numpy(), stats[k].numpy(),
                                   atol=2e-2 * max(1.0, float(
                                       stats[k].abs().max())), err_msg=k)


def test_full_resnet50_names_and_shapes_convert():
    """The reference recipe's whole CLIP parameter tree, with the full
    ResNet-50 and its batch_stats, converts key for key and shape for shape
    (``jax.eval_shape`` of JAX's init: nothing compiles), and loads into
    the port's ``CLIPModel(coco_full_config())`` strictly."""
    text = dict(vocab_size=64, dim=16, n_layers=1, n_heads=2, hidden_dim=32,
                max_position_embeddings=32)
    jcfg = jax_config.coco_full_config(compute_dtype="float32")
    jmodel = jax_clip.CLIPModel(
        jcfg, text_config=jax_distilbert.DistilBertConfig(**text))
    batch = {"image": jnp.zeros((1, 224, 224, 3)),
             "input_ids": jnp.zeros((1, 8), jnp.int32),
             "attention_mask": jnp.ones((1, 8), jnp.int32)}
    shapes = jax.eval_shape(lambda r: jmodel.init(r, batch),
                            jax.random.PRNGKey(0))
    assert set(shapes) == {"params", "batch_stats"}
    variables = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    tcfg = torch_config.coco_full_config(compute_dtype="float32")
    sd = state_dict_from_flax(variables, tcfg, DistilBertConfig(**text))
    bns = [k for k in sd if k.endswith("running_var")]
    convs = [k for k in sd if k.startswith("image_encoder")
             and sd[k].dim() == 4]
    assert len(bns) == len(convs) == 53
    assert sd["image_encoder.conv1.weight"].shape == (64, 3, 7, 7)
    assert sd["image_encoder.layer4.0.downsample.0.weight"].shape == (
        2048, 1024, 1, 1)
    assert sd["image_projection.projection.weight"].shape == (256, 2048)
    with torch.device("meta"):
        model = CLIPModel(tcfg, DistilBertConfig(**text), device="meta")
    model.load_state_dict(sd, strict=True, assign=True)


def test_converted_conv_kernel_is_oihw():
    """A 3x3 kernel with no symmetry: the converted weight gives JAX's
    output (OIHW), and the plain transpose the converter once used (OIWH,
    which passes the shape check) does not."""
    x = np.random.default_rng(3).normal(size=(2, 9, 9, 5)).astype(np.float32)
    conv = flax_nn.Conv(7, (3, 3), strides=(2, 2), padding=[(1, 1)] * 2,
                        use_bias=False)
    kernel = np.random.default_rng(4).normal(size=(3, 3, 5, 7)).astype(
        np.float32)
    want = np.asarray(conv.apply({"params": {"kernel": kernel}},
                                 jnp.asarray(x)))
    sd = {}
    _flatten({"conv": {"kernel": kernel}}, "", sd)
    port = Conv2d(5, 7, 3, 2)

    def run(weight):
        port.weight.data.copy_(weight)
        with torch.no_grad():
            return port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
                0, 2, 3, 1).numpy()

    np.testing.assert_allclose(run(sd["conv.weight"]), want, atol=1e-5,
                               rtol=1e-5)
    assert np.abs(run(torch.from_numpy(kernel.T.copy())) - want).max() > 0.1
