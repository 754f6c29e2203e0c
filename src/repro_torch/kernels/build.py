"""Build and load the port's hand-written CUDA kernels.

Each kernel is one source under ``src/repro_torch/csrc/`` with a plain C
interface.  It is compiled by ``nvcc`` for ``sm_90a`` into a shared
library and loaded with ``ctypes``; nothing includes PyTorch's headers,
so a build takes seconds.  Libraries land in ``build/repro_torch_kernels/``
at the repository root, named by a hash of their source and flags, so an
edited source rebuilds and an unchanged one is reused.  Nothing is built
when a module is imported: only the first CUDA call (or ``build_all``)
compiles.  A missing ``nvcc`` or a failed compile raises.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# every hand-written kernel of the port, by source name
KERNELS = ("hinm_spmm", "paged_attn", "nm_select")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cand = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "CUDA kernels are built from src/repro_torch/csrc at first use")
    return cand


def lib_path(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _build(name: str) -> str:
    """Compile one source unless its library exists; returns nvcc's log
    (``-Xptxas -v`` register/shared-memory report, empty when reused)."""
    out = lib_path(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
    res = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return res.stdout + res.stderr


def build_all(names=KERNELS) -> dict[str, str]:
    """Compile the named kernels (default: all of them), one nvcc per
    source, all at once; returns each build's log."""
    names = list(names)
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        return dict(zip(names, ex.map(_build, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel `name`, building it on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        _build(name)
        lib = _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
    return lib


def check(status: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {status}")
