"""Native (C++) host-side components, loaded via ctypes: the FASTQ decoder,
the NucleateGraph glue core and BaseGraph.checksum's FNV-1a loop.

The port's own copy of supernova_tpu/native/__init__.py (load_native,
decode_fastq_bytes, load_nucleate; fastq_decode.cpp and nucleate_core.cpp
unchanged), kept equal to it by tests/test_torch_hostcopies.py.  One
change: the shared libraries are built into supernova_tpu_torch/_build/,
keyed on the source hash, beside the port's CUDA kernels.  The pure-Python
paths are the reference's host code for machines without g++, not a device
fallback.  fnv1a_64 (fnv.cpp) is the port's own: the reference runs that
loop in Python.
"""
from __future__ import annotations

import ctypes
import hashlib
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).parent / "fastq_decode.cpp"
_LIB = None
_TRIED = False


def _build_dir() -> Path:
    d = Path(__file__).resolve().parents[1] / "_build"
    d.mkdir(parents=True, exist_ok=True)
    return d


def load_native():
    """-> ctypes CDLL or None (falls back to Python)."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        src = _SRC.read_bytes()
        tag = hashlib.sha1(src).hexdigest()[:12]
        so = _build_dir() / f"fastq_decode_{tag}.so"
        if not so.exists():
            subprocess.run(
                [
                    "g++", "-O3", "-march=native", "-shared", "-fPIC",
                    str(_SRC), "-o", str(so),
                ],
                check=True,
                capture_output=True,
            )
        lib = ctypes.CDLL(str(so))
        lib.fastq_scan.restype = ctypes.c_int
        lib.fastq_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.fastq_decode.restype = ctypes.c_int
        lib.fastq_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint8), np.ctypeslib.ndpointer(np.uint8),
            np.ctypeslib.ndpointer(np.int64), ctypes.c_int64,
        ]
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def decode_fastq_bytes(data: bytes):
    """Decompressed FASTQ bytes -> (codes u8, quals u8 phred, offsets i64).
    Native fast path with Python fallback."""
    lib = load_native()
    if lib is not None:
        nrec = ctypes.c_int64(0)
        nbase = ctypes.c_int64(0)
        rc = lib.fastq_scan(data, len(data), ctypes.byref(nrec), ctypes.byref(nbase))
        if rc == 0:
            codes = np.empty(nbase.value, np.uint8)
            quals = np.empty(nbase.value, np.uint8)
            offsets = np.empty(nrec.value + 1, np.int64)
            rc = lib.fastq_decode(data, len(data), codes, quals, offsets, nrec.value)
            if rc == 0:
                return codes, quals, offsets
        raise ValueError(f"malformed FASTQ (native rc={rc})")
    # pure python fallback
    from ..core import dna
    from ..ingest.fastq import qual_str_to_phred

    codes_l, quals_l = [], []
    lines = data.decode().splitlines()
    for i in range(0, len(lines) - 3, 4):
        codes_l.append(dna.seq_to_codes(lines[i + 1]))
        quals_l.append(qual_str_to_phred(lines[i + 3]))
    lens = np.array([len(c) for c in codes_l], np.int64)
    offsets = np.zeros(len(codes_l) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    return (
        np.concatenate(codes_l) if codes_l else np.zeros(0, np.uint8),
        np.concatenate(quals_l) if quals_l else np.zeros(0, np.uint8),
        offsets,
    )


_NUC_LIB = None
_NUC_TRIED = False


def load_nucleate():
    """ctypes handle to the NucleateGraph glue core, or None."""
    global _NUC_LIB, _NUC_TRIED
    if _NUC_LIB is not None or _NUC_TRIED:
        return _NUC_LIB
    _NUC_TRIED = True
    try:
        src_path = Path(__file__).parent / "nucleate_core.cpp"
        src = src_path.read_bytes()
        tag = hashlib.sha1(src).hexdigest()[:12]
        so = _build_dir() / f"nucleate_core_{tag}.so"
        if not so.exists():
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 str(src_path), "-o", str(so)],
                check=True, capture_output=True,
            )
        lib = ctypes.CDLL(str(so))
        i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.nucleate_glue.restype = ctypes.c_int
        lib.nucleate_glue.argtypes = [
            i32, i64, ctypes.c_int64,          # vals, offs, n
            i64, ctypes.c_int64,               # kmers, n_edges
            i64,                               # cinv
            ctypes.c_int64, ctypes.c_int64,    # min_over, floor
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # adaptive, interior, max_partners
            i64, ctypes.c_int64,               # extra_pairs, n_extra
            i64,                               # parent (out)
        ]
        _NUC_LIB = lib
    except Exception:
        _NUC_LIB = None
    return _NUC_LIB


_FNV_LIB = None
_FNV_TRIED = False


def fnv1a_64(data: bytes, h: int) -> int | None:
    """64-bit FNV-1a of `data` continuing from h (fnv.cpp, BaseGraph.checksum's
    loop), or None without g++ (the caller runs its Python loop: the same
    value)."""
    global _FNV_LIB, _FNV_TRIED
    if _FNV_LIB is None and not _FNV_TRIED:
        _FNV_TRIED = True
        try:
            src_path = Path(__file__).parent / "fnv.cpp"
            tag = hashlib.sha1(src_path.read_bytes()).hexdigest()[:12]
            so = _build_dir() / f"fnv_{tag}.so"
            if not so.exists():
                subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(src_path), "-o", str(so)],
                               check=True, capture_output=True)
            lib = ctypes.CDLL(str(so))
            lib.fnv1a_64.restype = ctypes.c_uint64
            lib.fnv1a_64.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint64]
            _FNV_LIB = lib
        except (OSError, subprocess.CalledProcessError):
            _FNV_LIB = None
    return None if _FNV_LIB is None else int(_FNV_LIB.fnv1a_64(data, len(data), h))
