"""Build and load the port's CUDA kernels (csrc/*.cu).

The sources are compiled at first use with nvcc, one process a source,
all started together, and linked into ONE shared library with a plain C
interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c -o <name>.o csrc/<name>.cu     (each source)
    nvcc ... -shared -o _build/<hash>/libsupernova_kernels.so *.o

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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]
LIB_NAME = "libsupernova_kernels.so"

P = ctypes.c_void_p
INT = ctypes.c_int
LL = ctypes.c_longlong

# C entry -> argtypes (every pointer and the stream as c_void_p)
SIGNATURES = {
    # codes, n, m, w0, w1, w2, stream
    "sn_kmer_extract": [P, LL, LL, P, P, P, P],
    # valid, n, ncols, in_ptrs[8], out_ptrs[8], esizes[8], fills[8] or
    # null, scratch, scratch_words, n_valid, stream
    "sn_compact": [P, LL, INT, P, P, P, P, P, LL, P, P],
    "sn_compact_tile_rows": [],
    # w0, w1, w2, pk, n, min_freq, min_bc, tails, tail_slots, keep, count,
    # stats, stream
    "sn_run_reduce": [P, P, P, P, LL, INT, INT, P, LL, P, P, P, P],
    "sn_run_reduce_tile_rows": [],
    "sn_radix_tile_rows": [],
    # key_ptrs[nkeys], nkeys, n, hist, stream
    "sn_radix_hist": [P, INT, LL, P, P],
    # src, write_keys, write_perm, kv_in, idx_in, column, n, shift, bins,
    # counter, status, status_words, tag, kv_out, idx_out, perm_out, stream
    "sn_radix_onesweep": [INT, INT, INT, P, P, P, LL, INT, P, P, P, LL, INT, P, P, P, P],
    # values or null, mask or null, out, n, esize, fill, scratch,
    # scratch_words, stream
    "sn_scan_max": [P, P, P, LL, INT, LL, P, LL, P],
    "sn_scan_max_tile_elems": [],
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
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()

    def start(cmd):
        return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True)

    def wait(jobs):
        """Wait for every job, then raise on the first that failed."""
        done = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in jobs]
        for cmd, out, rc in done:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")

    cus = [p for p in sources() if p.suffix == ".cu"]
    objs = [str(out_dir / f".{p.stem}.{tag}.o") for p in cus]
    # one process a source, all running at once
    wait([start([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(p)]) for obj, p in zip(objs, cus)])
    tmp = out_dir / f".{LIB_NAME}.{tag}"
    wait([start([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *objs])])
    for obj in objs:
        os.remove(obj)
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
