"""Build and load the port's CUDA kernels (nvcc into a shared library, C ABI).

Each source under ``mae_clip_torch/csrc/`` is compiled at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``build/kernels/`` at the repository root, keyed by a hash of the
source, of every ``csrc/`` header it includes, and of the flags, and loaded
with ``ctypes``. Nothing is built when the package is imported, so the CPU
tests never need ``nvcc``.

``nvcc`` is taken from ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``) or
the ``PATH``. The ``-Xptxas -v`` report (registers, shared memory, spills
per kernel) is kept beside each library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("attention_fwd.cu", "attention_bwd.cu", "patch_embed.cu",
           "block_stack_fwd.cu", "block_stack_bwd.cu")
_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _inputs(source: str) -> list:
    """``source`` and the ``csrc/`` headers it includes, transitively."""
    seen, todo = [], [source]
    while todo:
        name = todo.pop()
        if name not in seen:
            seen.append(name)
            todo += [m.decode() for m in
                     _LOCAL_INCLUDE.findall((CSRC / name).read_bytes())]
    return seen


def library_path(source: str) -> Path:
    """Where ``source``'s library lives once built (hash of the source, its
    included headers and the flags)."""
    h = hashlib.sha256()
    for name in _inputs(source):
        h.update(name.encode() + b"\0" + (CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}_{h.hexdigest()[:16]}.so"


def build(source: str) -> Path:
    """Compile ``source`` unless its library is already built; return it."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all(sources: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Build every source at once, one nvcc process each."""
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        paths = list(pool.map(build, sources))
    return dict(zip(sources, paths))


def ptxas_report(source: str) -> str:
    """The ``-Xptxas -v`` lines of ``source``'s build."""
    return library_path(source).with_suffix(".log").read_text()


_VP, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)


@functools.lru_cache(maxsize=None)
def load_attention() -> ctypes.CDLL:
    """The attention forward library, with its C signatures declared."""
    lib = ctypes.CDLL(str(build("attention_fwd.cu")))
    vp, i32, f32 = _VP, _I32, _F32
    lib.flash_attention_fwd.argtypes = [
        vp, vp, vp, vp, vp, vp, _STRIDES, i32, i32, i32, i32, i32, f32, i32,
        vp]
    lib.flash_attention_fwd.restype = i32
    lib.qkv_packed_attention_fwd.argtypes = [
        vp, vp, vp, vp, i32, i32, i32, i32, f32, i32, vp]
    lib.qkv_packed_attention_fwd.restype = i32
    lib.attention_error_string.argtypes = [i32]
    lib.attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def load_attention_bwd() -> ctypes.CDLL:
    """The attention backward library, with its C signatures declared."""
    lib = ctypes.CDLL(str(build("attention_bwd.cu")))
    vp, i32, f32 = _VP, _I32, _F32
    lib.flash_attention_bwd.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, _STRIDES,
        i32, i32, i32, i32, i32, f32, i32, vp]
    lib.flash_attention_bwd.restype = i32
    lib.qkv_packed_attention_bwd.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, f32, i32, vp]
    lib.qkv_packed_attention_bwd.restype = i32
    lib.attention_bwd_error_string.argtypes = [i32]
    lib.attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def load_patch_embed() -> ctypes.CDLL:
    """The masked patch-embed library, with its C signature declared."""
    lib = ctypes.CDLL(str(build("patch_embed.cu")))
    vp, i32 = _VP, _I32
    lib.masked_patch_embed_fwd.argtypes = [
        vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, vp]
    lib.masked_patch_embed_fwd.restype = i32
    lib.patch_embed_error_string.argtypes = [i32]
    lib.patch_embed_error_string.restype = ctypes.c_char_p
    return lib


_LL = ctypes.c_longlong
_PTRS = ctypes.POINTER(ctypes.c_void_p)
# The stacks' GEMM body alone (block_stack_{fwd,bwd}_gemm): a, b, bias, res,
# aux, out, out2, outf; M, N, K, a_km, b_kn, mode, gelu, splits; stream.
_GEMM_ARGS = [_VP] * 8 + [_I32] * 8 + [_VP]


@functools.lru_cache(maxsize=None)
def load_block_stack_fwd() -> ctypes.CDLL:
    """The block-stack forward library (kernel #6), with its C signatures."""
    lib = ctypes.CDLL(str(build("block_stack_fwd.cu")))
    vp, i32 = _VP, _I32
    lib.block_stack_fwd_workspace.argtypes = [i32] * 7
    lib.block_stack_fwd_workspace.restype = _LL
    lib.block_stack_fwd_state.argtypes = [i32] * 9 + [_STRIDES]
    lib.block_stack_fwd_state.restype = _LL
    lib.block_stack_fwd.argtypes = [vp, vp, _PTRS, vp, vp, vp, vp] \
        + [i32] * 10 + [vp]
    lib.block_stack_fwd.restype = i32
    lib.block_stack_fwd_gemm.argtypes = _GEMM_ARGS
    lib.block_stack_fwd_gemm.restype = i32
    lib.block_stack_error_string.argtypes = [i32]
    lib.block_stack_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def load_block_stack_bwd() -> ctypes.CDLL:
    """The block-stack backward library (kernel #7), with its C signatures."""
    lib = ctypes.CDLL(str(build("block_stack_bwd.cu")))
    vp, i32 = _VP, _I32
    lib.block_stack_bwd_workspace.argtypes = [i32] * 8
    lib.block_stack_bwd_workspace.restype = _LL
    lib.block_stack_bwd.argtypes = [vp, vp, _PTRS, vp, vp, vp, vp, _PTRS,
                                    vp] + [i32] * 10 + [vp]
    lib.block_stack_bwd.restype = i32
    lib.block_stack_bwd_gemm.argtypes = _GEMM_ARGS
    lib.block_stack_bwd_gemm.restype = i32
    lib.block_stack_bwd_dw_splits.argtypes = [i32] * 3
    lib.block_stack_bwd_dw_splits.restype = i32
    lib.block_stack_bwd_error_string.argtypes = [i32]
    lib.block_stack_bwd_error_string.restype = ctypes.c_char_p
    return lib
