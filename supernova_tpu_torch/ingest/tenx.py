"""10x Chromium FASTQ ingestion: interleaved/paired FASTQs -> ReadSet.

The port's own copy of supernova_tpu/ingest/tenx.py, kept equal to it by
tests/test_torch_hostcopies.py: the port imports nothing of the JAX package.

Reference layout (mro/assembler_cs.mro:25-26, tenkit fastq conventions):
R1 carries the 16 bp GEM barcode at its 5' end followed by `trim_length=7`
junk bases; R2 is genomic.  The whitelist is the 4M-with-alts barcode list.
This module is the SETUP_CHUNKS/BUCKET_FASTQS/SORT_FASTQS/
ParseBarcodedFastqs chain for on-disk data (ingest.ingest_pairs does the
correction + barcode sort).
"""
from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from .barcodes import BC_LEN, Whitelist
from .fastq import read_fastq
from .ingest import ingest_pairs
from .reads import ReadSet

TRIM_LENGTH = 7  # mro/assembler_cs.mro:26


def load_whitelist(path: str | Path) -> Whitelist:
    """Text whitelist: one 16bp barcode per line (like 4M-with-alts)."""
    from ..core import dna

    codes = []
    for line in Path(path).read_text().splitlines():
        line = line.strip().split("-")[0]
        if len(line) == BC_LEN:
            codes.append(dna.seq_to_codes(line))
    return Whitelist.from_codes(np.stack(codes))


def _read_fastq_arrays(path: str | Path):
    """Whole-file decode via the native C++ parser (Python fallback inside):
    -> (codes u8, quals u8 phred, offsets i64)."""
    import gzip

    from ..native import decode_fastq_bytes

    p = str(path)
    data = gzip.open(p, "rb").read() if p.endswith(".gz") else open(p, "rb").read()
    return decode_fastq_bytes(data)


def _fastq_chunks(path: str | Path, records_per_chunk: int):
    """Stream a FASTQ(.gz) as (codes, quals, offsets) blocks of exactly
    `records_per_chunk` records (last block smaller).

    The gz stream is inflated in fixed-size byte blocks and scanned for
    newline-aligned record boundaries (4 lines/record), so peak host
    memory is O(block), not O(file) — the ingest-side VirtualMasterVec
    rule (whole-file decode of a 16M-pair R1 held ~20 GB of text +
    arrays; at the reference's 2^31-read envelope it cannot be held)."""
    import gzip

    from ..native import decode_fastq_bytes

    p = str(path)
    f = gzip.open(p, "rb") if p.endswith(".gz") else open(p, "rb")
    block = 256 << 20
    lines_needed = records_per_chunk * 4
    buf = b""
    with f:
        while True:
            data = f.read(block)
            if not data:
                break
            buf = buf + data if buf else data
            while True:
                arr = np.frombuffer(buf, np.uint8)
                nl = np.flatnonzero(arr == 10)
                if len(nl) < lines_needed:
                    break
                cut = int(nl[lines_needed - 1]) + 1
                yield decode_fastq_bytes(buf[:cut])
                buf = buf[cut:]
    if buf.strip():
        yield decode_fastq_bytes(buf)


# whole-file decode above this compressed size streams in chunks instead
_CHUNKED_GZ_BYTES = 1 << 30
_RECORDS_PER_CHUNK = 1 << 21


def _paired_chunks(p1, p2):
    """Yield aligned ((c1,q1,o1),(c2,q2,o2)) chunk pairs of the two mate
    files, fetching the two streams concurrently (gzip inflate and the
    native parser release the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    g1 = _fastq_chunks(p1, _RECORDS_PER_CHUNK)
    g2 = _fastq_chunks(p2, _RECORDS_PER_CHUNK)
    sentinel = object()
    with ThreadPoolExecutor(2) as ex:
        while True:
            f1 = ex.submit(next, g1, sentinel)
            f2 = ex.submit(next, g2, sentinel)
            a, b = f1.result(), f2.result()
            if a is sentinel or b is sentinel:
                return
            yield a, b


def _within(lens: np.ndarray) -> np.ndarray:
    """Per-segment position index for a flat concat of `lens` segments."""
    total = int(lens.sum())
    excl = np.cumsum(lens) - lens
    return np.arange(total, dtype=np.int64) - np.repeat(excl, lens)


def _flat_pair_part(c1f, q1f, s1, l1, c2f, q2f, s2, l2, skip, room):
    """Assemble one file's pairs into the interleaved flat layout.

    -> (codes, quals, interleaved lens, bc2d, bcq2d) or None."""
    valid = l1 >= skip + 1
    if room is not None:
        keep_idx = np.flatnonzero(valid)[:room]
        valid = np.zeros_like(valid)
        valid[keep_idx] = True
    if (
        valid.all()
        and len(l1)
        and (l1 == l1[0]).all()
        and (l2 == l2[0]).all()
        and (np.diff(s1) == l1[0]).all()
        and (np.diff(s2) == l2[0]).all()
    ):
        # uniform-length fast path: the interleaved flat layout is a pure
        # reshape (the general path below builds several n-base int64
        # gather-index arrays — minutes of wall at 10^9 bases)
        rl1, rl2 = int(l1[0]), int(l2[0])
        npair = len(l1)
        base1 = int(s1[0])
        base2 = int(s2[0])
        r1c = c1f[base1 : base1 + npair * rl1].reshape(npair, rl1)
        r1q = q1f[base1 : base1 + npair * rl1].reshape(npair, rl1)
        r2c = c2f[base2 : base2 + npair * rl2].reshape(npair, rl2)
        r2q = q2f[base2 : base2 + npair * rl2].reshape(npair, rl2)
        bc2d = np.ascontiguousarray(r1c[:, :BC_LEN])
        bcq2d = np.ascontiguousarray(r1q[:, :BC_LEN])
        comb_c = np.concatenate([r1c[:, skip:], r2c], axis=1).reshape(-1)
        comb_q = np.concatenate([r1q[:, skip:], r2q], axis=1).reshape(-1)
        lens_i = np.empty(2 * npair, dtype=np.int64)
        lens_i[0::2] = rl1 - skip
        lens_i[1::2] = rl2
        return comb_c, comb_q, lens_i, bc2d, bcq2d
    s1v, l1v = s1[valid] + skip, l1[valid] - skip
    s2v, l2v = s2[valid], l2[valid]
    npair = len(s1v)
    if npair == 0:
        return None
    bc2d = c1f[s1[valid][:, None] + np.arange(BC_LEN)]
    bcq2d = q1f[s1[valid][:, None] + np.arange(BC_LEN)]
    idx1 = np.repeat(s1v, l1v) + _within(l1v)
    idx2 = np.repeat(s2v, l2v) + _within(l2v)
    lens_i = np.empty(2 * npair, dtype=np.int64)
    lens_i[0::2] = l1v
    lens_i[1::2] = l2v
    offs_i = np.zeros(2 * npair + 1, dtype=np.int64)
    np.cumsum(lens_i, out=offs_i[1:])
    comb_c = np.empty(int(lens_i.sum()), np.uint8)
    comb_q = np.empty_like(comb_c)
    d1 = np.repeat(offs_i[0:-1:2], l1v) + _within(l1v)
    d2 = np.repeat(offs_i[1:-1:2], l2v) + _within(l2v)
    comb_c[d1] = c1f[idx1]
    comb_q[d1] = q1f[idx1]
    comb_c[d2] = c2f[idx2]
    comb_q[d2] = q2f[idx2]
    return comb_c, comb_q, lens_i, bc2d, bcq2d


def ingest_10x_fastqs(
    r1_paths: Sequence[str | Path],
    r2_paths: Sequence[str | Path],
    wl: Whitelist,
    trim_length: int = TRIM_LENGTH,
    max_pairs: int | None = None,
    interleaved: bool = False,
) -> ReadSet:
    """Paired R1/R2 FASTQ(.gz) files -> barcode-corrected, sorted ReadSet.

    Fully vectorized: the per-file record loop of the reference's Rust
    sort-fastq is flat numpy gathers here (no per-read Python objects) —
    the pair-interleaved flat layout feeds build_readset_flat directly.

    interleaved=True reads BCL_PROCESSOR-style RA files (records alternate
    R1, R2 within one file; r1_paths carries them, r2_paths is ignored)."""
    skip = BC_LEN + trim_length
    parts = []  # (codes, quals, offsets-interleaved, bc2d, bcq2d)
    n_total = 0
    pairs_iter = (
        [(p, None) for p in r1_paths] if interleaved else zip(r1_paths, r2_paths)
    )
    for p1, p2 in pairs_iter:
        if max_pairs and n_total >= max_pairs:
            break
        if interleaved:
            cf, qf, o = _read_fastq_arrays(p1)
            lens = np.diff(o)
            n = (len(o) - 1) // 2 * 2
            c1f = c2f = cf
            q1f = q2f = qf
            s1, l1 = o[:n][0::2], lens[:n][0::2]
            s2, l2 = o[:n][1::2], lens[:n][1::2]
        else:
            big = max(Path(p1).stat().st_size, Path(p2).stat().st_size)
            if big > _CHUNKED_GZ_BYTES:
                # stream large mate files in aligned record chunks so the
                # decompressed text is never fully resident
                for (c1f, q1f, o1), (c2f, q2f, o2) in _paired_chunks(p1, p2):
                    if max_pairs and n_total >= max_pairs:
                        break
                    n = min(len(o1), len(o2)) - 1
                    s1, l1 = o1[:n], np.diff(o1)[:n]
                    s2, l2 = o2[:n], np.diff(o2)[:n]
                    room = (max_pairs - n_total) if max_pairs else None
                    part = _flat_pair_part(
                        c1f, q1f, s1, l1, c2f, q2f, s2, l2, skip, room
                    )
                    if part is None:
                        continue
                    n_total += len(part[3])
                    parts.append(part)
                continue
            # decode the mates concurrently: gzip inflate and the native
            # parser both release the GIL (~2x at 10^9-base scale)
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(2) as ex:
                f1 = ex.submit(_read_fastq_arrays, p1)
                f2 = ex.submit(_read_fastq_arrays, p2)
                c1f, q1f, o1 = f1.result()
                c2f, q2f, o2 = f2.result()
            n = min(len(o1), len(o2)) - 1
            s1, l1 = o1[:n], np.diff(o1)[:n]
            s2, l2 = o2[:n], np.diff(o2)[:n]
        room = (max_pairs - n_total) if max_pairs else None
        part = _flat_pair_part(c1f, q1f, s1, l1, c2f, q2f, s2, l2, skip, room)
        if part is None:
            continue
        n_total += len(part[3])
        parts.append(part)
    if not parts:
        raise ValueError("no read pairs found in input FASTQs")
    parts = [list(p) for p in parts]

    def take(i):
        # concatenate one field and drop the per-part buffers immediately
        # (keeps the concat peak at ~1x the field, not 2x all fields)
        out = np.concatenate([p[i] for p in parts])
        for p in parts:
            p[i] = None
        return out

    codes = take(0)
    quals = take(1)
    lens = take(2)
    offsets = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    bc_codes = take(3)
    bc_quals = take(4)

    from .ingest import correct_two_pass
    from .reads import build_readset_flat

    wl_idx = correct_two_pass(wl, bc_codes, bc_quals)
    bc_ids = (wl_idx + 1).astype(np.int32)
    return build_readset_flat(
        codes, offsets, quals, bc_ids, n_barcodes=len(wl), barcoded=True
    )


def write_sim_fastqs(sim, outdir: str | Path, trim_length: int = TRIM_LENGTH):
    """Write a SimReads as 10x-style R1/R2 FASTQs (for CLI round-trips)."""
    from ..core import dna
    from .fastq import write_fastq

    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    r1recs, r2recs = [], []
    for i in range(sim.n_pairs()):
        bc = sim.barcode[i]
        junk = np.zeros(trim_length, dtype=np.uint8)
        c1 = np.concatenate([bc, junk, sim.r1[i]])
        q1 = np.concatenate(
            [sim.bc_qual[i], np.full(trim_length, 37, np.uint8), sim.q1[i]]
        )
        r1recs.append((f"read{i}", c1, q1))
        r2recs.append((f"read{i}", sim.r2[i], sim.q2[i]))
    write_fastq(outdir / "sample_R1.fastq.gz", r1recs)
    write_fastq(outdir / "sample_R2.fastq.gz", r2recs)
    return outdir / "sample_R1.fastq.gz", outdir / "sample_R2.fastq.gz"
