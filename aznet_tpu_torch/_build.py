"""Build and load the port's CUDA kernels (``aznet_tpu_torch/csrc/*.cu``).

The sources have a plain C interface and are compiled by ``nvcc`` into one
shared library, loaded with ``ctypes``; no PyTorch headers are involved, so a
build takes seconds. The library goes to ``build/aznet_tpu_torch/<hash>/``
under the repository root, keyed by a hash of the sources and flags, and is
built at first use in a process. There is no fallback: a missing ``nvcc`` or
a failed build raises.

Flags: ``sm_90a`` (Hopper), no ``--use_fast_math`` (it flushes subnormals and
approximates division) and ``--fmad=false`` (no multiply-add contraction), so
the NMS kernel's IoU rounds exactly as the reference's separate operations.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "aznet_tpu_torch"
LIB_NAME = "libaznet_tpu_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "--fmad=false", "-Xptxas", "-v",
)

_lib = None


def find_nvcc() -> str:
    """``nvcc`` under the CUDA root that ``torch.utils.cpp_extension`` finds
    (``$CUDA_HOME``, ``$CUDA_PATH``, ``nvcc`` on ``PATH``, the default
    install); raises when there is none."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not nvcc.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(nvcc)


def build() -> Path:
    """Compile the sources if this hash has no library yet; return its path."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "nvcc.log").write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib_path)  # atomic: a concurrent build never sees a partial file
    return lib_path


def load() -> ctypes.CDLL:
    """The kernel library, built and loaded once per process."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib
