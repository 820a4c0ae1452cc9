"""Build and load the CUDA kernels of `cuvs_rag_tpu_torch/csrc/`.

Each `.cu` file is compiled by nvcc for sm_90a into a shared library with a
plain C interface, loaded with ctypes. The build runs at first use into
`build/kernels/` at the repository root and is keyed by a hash of the
source, the shared `.cuh` headers and the flags, so a changed source
rebuilds and an unchanged one loads the library already built. Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures of the entry points of each source (see the .cu file).
SIGNATURES = {
    "flat_topk.cu": {
        "flat_exact_topk": [
            _I, _P, _P, _P, _P, _I, _I, _L, _I, _I, _I, _L, _I,
            _P, _P, _P, _P, _P,
        ],
        "flat_sketch_topk": [
            _I, _P, _P, _P, _P, _P, _I, _I, _L, _I, _I, _I, _I, _L, _I,
            _P, _P, _P, _P, _P,
        ],
        "flat_topr": [
            _I, _P, _P, _P, _P, _I, _I, _L, _I, _I, _I, _I, _L, _I,
            _P, _P, _P, _P, _P, _P, _P,
        ],
    },
    "ivf_scan.cu": {
        "ivf_scan_topk": [
            _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
            _P, _P, _P, _P, _P,
        ],
        "ivf_scan_topr": [
            _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
            _P, _P, _P, _P,
        ],
    },
    "pq_adc.cu": {
        "pq_adc_scores": [
            _P, _P, _P, _P, _P, _P, _P, _I, _I, _L, _I, _P, _P, _P,
        ],
    },
    "flash_attn.cu": {
        "flash_attention": [
            _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P,
        ],
    },
    "stream.cu": {
        "read_all": [_P, _L, _I, _I, _I, _I, _P, _P, _P],
        "gather_rows": [_P, _P, _P, _L, _I, _L, _I, _P],
        "gather_reduce": [_P, _P, _L, _I, _I, _I, _P, _P, _P],
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels")


def _build(source: str) -> Path:
    src = CSRC / source
    # the shared headers are part of every source
    parts = [src.read_bytes()] + [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(
        b"".join(parts) + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"{src.stem}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load one source's library, with argtypes set
    for every entry point. Each entry point returns a cudaError_t."""
    lib = ctypes.CDLL(str(_build(source)))
    for name, argtypes in SIGNATURES[source].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch
    never runs, and synchronize() would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
