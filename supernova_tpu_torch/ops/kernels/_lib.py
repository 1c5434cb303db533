"""Build and load the port's CUDA kernels (csrc/*.cu).

The sources are compiled at first use with nvcc into ONE shared library
with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/<hash>/libsupernova_kernels.so csrc/*.cu

The build directory `supernova_tpu_torch/_build/` is keyed on a hash of
the sources and flags, so an edited kernel rebuilds and an unchanged one
loads at once.  No PyTorch header is compiled (a build takes seconds, not
the minutes of torch.utils.cpp_extension).  Every C entry launches on the
stream it is given and returns cudaGetLastError(); `check` raises on a
nonzero code.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
LIB_NAME = "libsupernova_kernels.so"

P = ctypes.c_void_p
INT = ctypes.c_int
LL = ctypes.c_longlong

# C entry -> argtypes (every pointer and the stream as c_void_p)
SIGNATURES = {
    # codes, n, m, w0, w1, w2, stream
    "sn_kmer_extract": [P, LL, LL, P, P, P, P],
    # valid, n, ncols, in_ptrs[8], out_ptrs[8], esizes[8], counts,
    # offsets, n_valid, stream
    "sn_compact": [P, LL, INT, P, P, P, P, P, P, P],
    # w0, w1, w2, pk, n, min_freq, min_bc, keep, count, stats, stream
    "sn_run_reduce": [P, P, P, P, LL, INT, INT, P, P, P, P],
    # key, n, and_or[2], stream
    "sn_radix_bits": [P, LL, P, P],
    # key, idx, n, init, kv, stream
    "sn_radix_gather": [P, P, LL, INT, P, P],
    # kv_in, idx_in, n, shift, counts, offsets, totals, kv_out, idx_out, stream
    "sn_radix_pass": [P, P, LL, INT, P, P, P, P, P, P],
    # idx (or NULL), n, perm, stream
    "sn_radix_perm": [P, LL, P, P],
}


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/ into the hash-keyed build directory (no-op when the
    library for these sources exists) and return its path."""
    out_dir = BUILD_DIR / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    cus = [str(p) for p in sources() if p.suffix == ".cu"]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *cus]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stdout}{res.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent build never loads half a file
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The built, loaded kernel library with every entry's argtypes set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {code}")


def require(t: torch.Tensor, name: str, dtype, device: torch.device, n: int | None = None):
    """Raise unless `t` is a contiguous 1-D tensor of `dtype` on `device`
    (and of length n when given)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name}: must be a contiguous 1-D tensor")
    if n is not None and t.shape[0] != n:
        raise ValueError(f"{name}: length {t.shape[0]}, expected {n}")
