"""Build and load the CUDA kernels of `cuvs_rag_tpu_torch/csrc/`.

Each `.cu` file is compiled by nvcc for sm_90a into a shared library with a
plain C interface, loaded with ctypes. The build runs at first use into
`build/kernels/` at the repository root and is keyed by a hash of the
source, the shared `.cuh` headers and the flags, so a changed source
rebuilds and an unchanged one loads the library already built; what
`ptxas -v` said of each kernel is kept beside the library (`resources`).
Nothing here runs at import time.

It is also the wrappers' one way to the card: `launcher` makes a launch of
an entry point, with its span, error check and count (`launches`), and the
card facts the wrappers plan with live here once (`sm_count`, the shared
memory limits, `aligned`, `require_cuda`).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

from cuvs_rag_tpu_torch.utils import profiling

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Shared memory of an H100 SM, what one block may take of it, and what the
# card keeps back for each resident block (bytes).
SM_SMEM = 228 * 1024
MAX_SMEM = 227 * 1024
BLOCK_RESERVED = 1024

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures of the entry points of each source (see the .cu file).
SIGNATURES = {
    "flat_topk.cu": {
        "flat_exact_topk": [
            _I, _I, _P, _P, _P, _P, _I, _I, _L, _I, _I, _I, _L, _I,
            _P, _P, _P, _P, _P,
        ],
        "flat_exact_wide_topk": [
            _I, _P, _P, _P, _P, _I, _I, _L, _I, _I, _I, _I, _I, _L, _I,
            _P, _P, _P, _P, _P,
        ],
        "flat_sketch_topk": [
            _I, _I, _P, _P, _P, _P, _P, _I, _I, _L, _I, _I, _I, _I, _L, _I,
            _P, _P, _P, _P, _P,
        ],
        "flat_topr": [
            _I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _L, _I, _I, _I, _I, _L,
            _I, _P, _P, _P, _P, _P, _P, _P,
        ],
    },
    "ivf_scan.cu": {
        "ivf_scan_topk": [
            _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
            _I, _I, _P, _P, _P, _P, _P,
        ],
        "ivf_scan_topr": [
            _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
            _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
        ],
    },
    "pq_adc.cu": {
        "pq_adc_scores": [
            _P, _P, _P, _P, _P, _P, _P, _I, _I, _L, _I, _I, _I, _P, _P, _P,
            _P,
        ],
    },
    "flash_attn.cu": {
        "flash_attention": [
            _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P,
        ],
    },
    "graph.cu": {
        "cagra_candidates_blocks": [_I, _I, _L],
        "cagra_candidates": [
            _P, _I, _I, _P, _I, _P, _L, _P, _L, _F, _P, _I, _P, _I, _I, _I,
            _I, _I, _P, _P, _P,
        ],
        "cagra_merge": [
            _P, _P, _P, _I, _P, _L, _P, _L, _I, _I, _I, _I, _P, _P, _P,
        ],
    },
    "stream.cu": {
        "read_all": [_P, _L, _I, _I, _I, _I, _P, _P, _P],
        "gather_rows": [_P, _P, _P, _L, _I, _L, _I, _I, _P],
        "gather_reduce": [_P, _P, _L, _I, _I, _I, _P, _P, _P],
    },
}


# Launches of each entry point in this process, counted by `launcher`; a run
# reads differences, or sets them to 0. A wrapper's count is the sum of its
# entries'.
launches = {entry: 0 for entries in SIGNATURES.values() for entry in entries}


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
        # what ptxas said of each kernel (registers, spills): `resources`
        lib.with_suffix(".log").write_text(proc.stderr)
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


def resources(source: str) -> dict:
    """Registers, spilled bytes (stores, loads) and static shared memory of
    each kernel of a built source, as `ptxas -v` printed them at its build:
    {"flash_attn_wgmma_kernel<128>": {"registers": ..., ...}, ...}. Integer
    template arguments are shown, type arguments are not."""
    log = _build(source).with_suffix(".log").read_text()
    out = {}
    for entry in log.split("Compiling entry function")[1:]:
        name = _kernel_name(entry.split("'")[1])
        regs = re.search(r"Used (\d+) registers", entry)
        if not name or not regs:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          entry)
        smem = re.search(r"(\d+) bytes smem", entry)
        out[name] = {
            "registers": int(regs.group(1)),
            "spill_store_bytes": int(spill.group(1)) if spill else 0,
            "spill_load_bytes": int(spill.group(2)) if spill else 0,
            "static_smem_bytes": int(smem.group(1)) if smem else 0,
        }
    return out


def _kernel_name(mangled: str) -> str | None:
    """`name<ints>` of a mangled `..._kernel` symbol (identifiers are
    length-prefixed; integer template arguments read `Li<n>E`)."""
    found = None  # the last match: the kernel's own name, not a scope's
    for m in re.finditer(r"\d+", mangled):
        for cut in range(len(m.group())):
            n = int(m.group()[cut:])
            name, rest = mangled[m.end():m.end() + n], mangled[m.end() + n:]
            if len(name) == n and name.endswith("_kernel"):
                args = re.match(r"I((?:Li\d+E)+)E", rest)
                ints = re.findall(r"Li(\d+)E", args.group(1)) if args else []
                found = name + (f"<{','.join(ints)}>" if ints else "")
    return found


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """SMs of a CUDA device, looked up once a device."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def aligned(t):
    """`t`, or a copy where its first byte is not 16-byte aligned (a view
    that starts inside an allocation): the kernels copy 16 bytes a load."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def require_cuda(t) -> None:
    """Raise unless `t` lies on a CUDA device: the wrappers run their plain
    versions on CPU tensors and have a kernel for CUDA tensors only."""
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {t.device}")


def device_guard(device):
    """A context manager that makes the CUDA `device` current for a launch
    (kernels launch into the current device's context), and nothing where it
    already is: the usual caller, whom `torch.cuda.device`'s enter and exit
    would cost microseconds a call."""
    import torch

    # a tensor lies on `device`, so CUDA is initialized: no lazy-init check
    if device.index in (None, torch._C._cuda_getDevice()):
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def raw_stream(device) -> int:
    """The handle of PyTorch's current stream on the CUDA `device`, without
    building a `torch.cuda.Stream` around it, which costs a launch-bound
    caller several microseconds a call."""
    import torch

    return torch._C._cuda_getCurrentRawStream(
        torch._C._cuda_getDevice() if device.index is None else device.index)


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch
    never runs, and synchronize() would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def launcher(source: str, entry: str, device, *, kernel: str):
    """The one way a wrapper launches a kernel: a callable that takes the
    arguments of C entry point `entry` of `source` but the last, the
    stream, and launches on `device`. The C function and PyTorch's current
    stream of the device are resolved when the launcher is made. Each call
    makes the device current where it is not, records the C call as the
    span `kernel.launch` with the label `kernel` and the device's index
    (the benchmark pins device events to that span's start), raises on a
    CUDA error under `entry`'s name and counts one launch in
    `launches[entry]`."""
    fn = getattr(load(source), entry)
    stream = raw_stream(device)
    index = device.index

    def launch(*args):
        with device_guard(device), profiling.span(
                "kernel.launch", kernel=kernel, device=index):
            err = fn(*args, stream)
        check(err, entry)
        launches[entry] += 1

    return launch
