"""Feudal / BINWRITE interop: read and write the reference's on-disk
formats so its intermediates (fastb / bci / bv graph files) can move in
and out of this framework.

The port's own copy of supernova_tpu/ingest/feudal.py, kept equal to it by
tests/test_torch_hostcopies.py apart from the next line, whose original
names a local checkout: the port imports nothing of the JAX package.

Formats (reverse-engineered from the reference's sources, cited per function):
  * BINWRITE stream: 8-byte "BINWRITE" magic
    (feudal/BinaryStream.h:34-46); a vec<T> is u64 count + raw
    little-endian elements (BinaryStream.h:486-499); BinaryIteratingWriter
    emits the count right after the magic (BinaryStream.h:400-424).
    The `.bci` barcode index is such a vec<int64_t>
    (10X/ParseBarcodedFastqs.cc:174).
  * vec<basevector> "bv" file (tada's asm_graph / DF's MSPEDGES input):
    magic, u64 n, then per edge u32 len-in-bases + ceil(len/4) packed
    bytes with base code j at bit (j%4)*2, 00=A 01=C 10=G 11=T
    (lib/tada/src/debruijn.rs:885-930).
  * feudal file (fastb = MasterVec<FieldVec<2>>): 24-byte control block
    {u32 n; u8 bitflags; u8 sizeofFixed; u8 sizeofX; u8 sizeofA;
     u64 varOffset; u64 fixedOffset} (feudal/FeudalControlBlock.h:28-160),
    then per-element variable data (2-bit packed bases, same bit layout —
    FieldVec.h:753-769), then an (n+1)-entry u64 table of ABSOLUTE file
    offsets of each element's variable data (FeudalFileReader.h:95-99,
    first entry = 24, last = varOffset), then fixed data =
    u32 base-count per element (FieldVec.h:585-607).

Base codes are the framework's own (0=A 1=C 2=G 3=T, core/dna.py) — the
two encodings coincide.
"""
from __future__ import annotations

import struct

import numpy as np

from ..core.ragged import Ragged

MAGIC = b"BINWRITE"
# FeudalControlBlock is {uint; 4 x uchar; 2 x size_t} = 4+4+8+8 = 24 bytes
# on LP64 (the first size_t lands at offset 8, already aligned)
_FCB = struct.Struct("<IBBBBQQ")
assert _FCB.size == 24


# ------------------------------------------------------------ 2-bit packing

def pack_codes(codes: np.ndarray) -> np.ndarray:
    """uint8 base codes -> packed bytes, code j at bit (j%4)*2."""
    n = len(codes)
    pad = (-n) % 4
    c = np.concatenate([codes.astype(np.uint8), np.zeros(pad, np.uint8)])
    c = c.reshape(-1, 4)
    return (
        c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)
    ).astype(np.uint8)


def unpack_codes(packed: np.ndarray, n_bases: int) -> np.ndarray:
    """packed bytes -> uint8 base codes (vectorized; trailing pad cut)."""
    b = np.asarray(packed, np.uint8)
    out = np.empty((len(b), 4), np.uint8)
    out[:, 0] = b & 3
    out[:, 1] = (b >> 2) & 3
    out[:, 2] = (b >> 4) & 3
    out[:, 3] = (b >> 6) & 3
    return out.reshape(-1)[:n_bases]


# --------------------------------------------------------- BINWRITE vec<T>

def read_binwrite_vec(path, dtype=np.int64) -> np.ndarray:
    """BINWRITE vec<T> file -> flat array (e.g. the .bci barcode index)."""
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != MAGIC:
            raise ValueError(f"{path}: not a BINWRITE file")
        (n,) = struct.unpack("<Q", f.read(8))
        return np.fromfile(f, dtype=dtype, count=n)


def write_binwrite_vec(path, arr: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(arr)))
        np.ascontiguousarray(arr).tofile(f)


read_bci = read_binwrite_vec
write_bci = write_binwrite_vec


# ------------------------------------------- BINWRITE vec<basevector> (bv)

def read_bvecs(path) -> Ragged:
    """tada-style vec<basevector> file -> Ragged base codes
    (debruijn.rs:845-883 read_from_sn_format)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != MAGIC:
        raise ValueError(f"{path}: not a BINWRITE file")
    (n,) = struct.unpack_from("<Q", data, 8)
    pos = 16
    lens = np.empty(n, np.int64)
    chunks = []
    for i in range(n):
        (ln,) = struct.unpack_from("<I", data, pos)
        pos += 4
        nbytes = (ln + 3) // 4
        lens[i] = ln
        chunks.append(
            unpack_codes(np.frombuffer(data, np.uint8, nbytes, pos), ln)
        )
        pos += nbytes
    values = (
        np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)
    )
    offsets = np.concatenate([[0], np.cumsum(lens)])
    return Ragged(values, offsets)


def write_bvecs(path, rows: Ragged) -> None:
    """Ragged base codes -> tada-style vec<basevector> file
    (debruijn.rs:885-930 write_to_sn_format)."""
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", rows.n_rows))
        for i in range(rows.n_rows):
            row = rows.row(i)
            f.write(struct.pack("<I", len(row)))
            pack_codes(row).tofile(f)


# ------------------------------------------------------------ feudal fastb

def read_fastb(path) -> Ragged:
    """Feudal MasterVec<basevector> (.fastb) -> Ragged base codes."""
    with open(path, "rb") as f:
        data = f.read()
    n, flags, szf, szx, sza, var_off, fixed_off = _FCB.unpack_from(data, 0)
    if (flags & 3) != 1:
        raise ValueError(f"{path}: need single-file feudal format")
    n_elem = (fixed_off - var_off) // 8 - 1
    if (n_elem & 0xFFFFFFFF) != n:
        raise ValueError(f"{path}: offset table disagrees with element count")
    offs = np.frombuffer(data, np.uint64, n_elem + 1, var_off).astype(np.int64)
    lens = np.frombuffer(data, np.uint32, n_elem, fixed_off).astype(np.int64)
    # unpack the whole variable chunk once, then slice per element: element
    # i's codes start at 4 * (offs[i] - offs[0]) within the unpacked span
    var = np.frombuffer(data, np.uint8, int(offs[-1] - offs[0]), int(offs[0]))
    codes = unpack_codes(var, len(var) * 4)
    starts = (offs[:-1] - offs[0]) * 4
    total = int(lens.sum())
    values = np.empty(total, np.uint8)
    out_off = np.concatenate([[0], np.cumsum(lens)])
    # vectorized ragged gather: index = starts repeated + in-row arange
    idx = np.repeat(starts, lens) + (
        np.arange(total) - np.repeat(out_off[:-1], lens)
    )
    values[:] = codes[idx]
    return Ragged(values, out_off)


def _read_feudal_raw(path):
    """-> (data bytes, (n+1,) absolute offsets, fixed_off, n_elem)."""
    with open(path, "rb") as f:
        data = f.read()
    n, flags, szf, szx, sza, var_off, fixed_off = _FCB.unpack_from(data, 0)
    if (flags & 3) != 1:
        raise ValueError(f"{path}: need single-file feudal format")
    n_elem = (fixed_off - var_off) // 8 - 1
    if (n_elem & 0xFFFFFFFF) != n:
        raise ValueError(f"{path}: offset table disagrees with element count")
    offs = np.frombuffer(data, np.uint64, n_elem + 1, var_off).astype(np.int64)
    return data, offs, fixed_off, n_elem


# ------------------------------------------------- PQVec (.qualp) encoding

def pqvec_decode(buf: bytes) -> np.ndarray:
    """One PQVec buffer -> uint8 quals (feudal/PQVec.cc:87-127 encode):
    blocks of [u8 nQs][bitstream: 3b nBits, 6b minQ, nQs x nBits values],
    each block starting byte-aligned, stream terminated by an nQs=0 byte."""
    out = []
    pos = 0
    while True:
        nqs = buf[pos]
        pos += 1
        if nqs == 0:
            break
        nbits_probe = buf[pos] & 7
        nbytes = (9 + nqs * nbits_probe + 7) >> 3
        field = int.from_bytes(buf[pos : pos + nbytes], "little")
        nbits = field & 7
        minq = (field >> 3) & 63
        if nbits == 0:
            out.append(np.full(nqs, minq, np.uint8))
        else:
            vals = field >> 9
            mask = (1 << nbits) - 1
            shifts = np.arange(nqs, dtype=object) * nbits
            arr = np.fromiter(
                ((vals >> int(s)) & mask for s in shifts), np.uint8, nqs
            )
            out.append(arr + np.uint8(minq))
        pos += nbytes
    return (
        np.concatenate(out) if out else np.zeros(0, np.uint8)
    )


def pqvec_encode(quals: np.ndarray, block: int = 255) -> bytes:
    """uint8 quals -> a valid PQVec buffer.  Uses fixed <=255-qual blocks
    with per-block (minQ, bit-width) instead of the reference's optimal DP
    partition — decodes identically under PQVecEncoder::decode."""
    q = np.asarray(quals, np.uint8)
    if q.size and int(q.max()) > 63:
        raise ValueError("quality score > 63 (PQVec limit)")
    parts = []
    for lo in range(0, len(q), block):
        chunk = q[lo : lo + block].astype(np.int64)
        nqs = len(chunk)
        minq = int(chunk.min())
        span = int(chunk.max()) - minq + 1
        nbits = int(span - 1).bit_length()
        field = nbits | (minq << 3)
        if nbits:
            vals = chunk - minq
            acc = 0
            for i in range(nqs - 1, -1, -1):
                acc = (acc << nbits) | int(vals[i])
            field |= acc << 9
        nbytes = (9 + nqs * nbits + 7) >> 3
        parts.append(bytes([nqs]) + field.to_bytes(nbytes, "little"))
    parts.append(b"\0")
    return b"".join(parts)


def read_qualp(path) -> Ragged:
    """Feudal MasterVec<PQVec> (.qualp) -> Ragged uint8 quals.  PQVec has
    no fixed data (PQVec.h:170); element sizes come from the offset table."""
    data, offs, fixed_off, n = _read_feudal_raw(path)
    rows = [
        pqvec_decode(data[int(offs[i]) : int(offs[i + 1])]) for i in range(n)
    ]
    values = np.concatenate(rows) if rows else np.zeros(0, np.uint8)
    lens = np.array([len(r) for r in rows], np.int64)
    return Ragged(values, np.concatenate([[0], np.cumsum(lens)]))


def write_qualp(path, rows: Ragged) -> None:
    bufs = [pqvec_encode(rows.row(i)) for i in range(rows.n_rows)]
    n = len(bufs)
    sizes = np.array([len(b) for b in bufs], np.int64)
    var_off = 24 + int(sizes.sum())
    fixed_off = var_off + (n + 1) * 8
    offs = 24 + np.concatenate([[0], np.cumsum(sizes)])
    with open(path, "wb") as f:
        f.write(_FCB.pack(n & 0xFFFFFFFF, 1, 0, 0, 1, var_off, fixed_off))
        for b in bufs:
            f.write(b)
        f.write(offs.astype(np.uint64).tobytes())


def write_fastb(path, rows: Ragged) -> None:
    """Ragged base codes -> feudal MasterVec<basevector> (.fastb)."""
    n = rows.n_rows
    lens = rows.lengths().astype(np.int64)
    nbytes = (lens + 3) // 4
    var_off = 24 + int(nbytes.sum())
    fixed_off = var_off + (n + 1) * 8
    offs = 24 + np.concatenate([[0], np.cumsum(nbytes)])
    with open(path, "wb") as f:
        # sizeofX/sizeofA are sanity hints only ("may be 0",
        # FeudalControlBlock.h:131-144); sizeofFixed must match the u32
        # per-element length record
        f.write(_FCB.pack(n & 0xFFFFFFFF, 1, 4, 0, 1, var_off, fixed_off))
        for i in range(n):
            pack_codes(rows.row(i)).tofile(f)
        f.write(offs.astype(np.uint64).tobytes())
        f.write(lens.astype(np.uint32).tobytes())
