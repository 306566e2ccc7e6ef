"""The PyTorch port stands alone: no module of mae_clip_torch, and not
chip_smoke.py, imports JAX, flax or the JAX package; importing the port
leaves jax unloaded; its entry points default to the card; and its own copy
of the config stays equal to the JAX package's for every preset."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from mae_clip_tpu import config as jax_config
from mae_clip_torch import config as torch_config
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "mae_clip_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mae_clip_tpu")
PRESETS = ["reference_py_config", "notebook_config", "flagship_tpu_config",
           "flagship_siglip_config", "mae_pretrain_config",
           "coco_full_config", "large_batch_mesh_config"]


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_nothing_of_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax_and_builds_nothing():
    """Importing every module leaves JAX and the JAX package unloaded, and
    runs no nvcc: with no CUDA toolkit reachable the imports still succeed
    (the kernels build at their first launch)."""
    code = ("import sys, mae_clip_torch, mae_clip_torch.serve, "
            "mae_clip_torch.models, mae_clip_torch.interop.from_jax, "
            "mae_clip_torch.ops.attention, mae_clip_torch.train, "
            "mae_clip_torch.data.device_store; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={"CUDA_HOME": str(ROOT / "no-cuda-here"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("preset", PRESETS + ["Config"])
def test_config_copy_matches_jax(preset):
    want = getattr(jax_config, preset)()
    got = getattr(torch_config, preset)()
    assert got.to_dict() == want.to_dict()
    assert torch_config.Config.from_dict(want.to_dict()) == got
    got.validate()
    assert got.text_cache_enabled == want.text_cache_enabled
    if got.model_name in ("resnet50", "vit_s16", "vit_b16"):
        assert got.image_feature_dim == want.image_feature_dim


def test_config_overrides_match_jax():
    sets = ["mae.decoder_style=cross", "batch_size=64", "gelu_impl=tanh",
            "mesh.axis_names=[\"d\", \"m\"]"]
    assert (torch_config.flagship_tpu_config().with_overrides(sets).to_dict()
            == jax_config.flagship_tpu_config().with_overrides(sets).to_dict())


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card, the default device raises instead of running on the
    CPU; device='cpu' must be asked for."""
    from mae_clip_torch.data.device_store import (DeviceStore,
                                                  build_device_store)
    from mae_clip_torch.device import resolve_device
    from mae_clip_torch.models import CLIPModel, DistilBertConfig, ViTConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = torch_config.Config(model_name="vit_s16", size=16,
                              compute_dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA"):
        CLIPModel(cfg, DistilBertConfig(dim=16, n_layers=1, n_heads=2,
                                        hidden_dim=32),
                  ViTConfig(image_size=16, patch_size=8, dim=16, depth=1,
                            n_heads=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        CLIPModel(torch_config.coco_full_config(),
                  DistilBertConfig(dim=16, n_layers=1, n_heads=2,
                                   hidden_dim=32))
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceStore({"image": np.zeros((2, 4, 4, 3), np.uint8)})
    with pytest.raises(RuntimeError, match="CUDA"):
        build_device_store(None, images=np.zeros((2, 4, 4, 3), np.uint8))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_exits_nonzero_without_a_card():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={"CUDA_VISIBLE_DEVICES": "",
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
