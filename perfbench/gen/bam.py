"""Frozen synthetic BAM generators: a name-collated transcriptome BAM
(bulk) and a CB-collated one (single-cell).

Copies of `oarfish_tpu_torch/bench.py::build_e2e_bam` and
`oarfish_tpu_torch/bench_modes.py::build_sc_bam`, kept here so that a
change to the program cannot change the benchmark's inputs. The sizes
come from a configuration file (`perfbench/configs/<name>.json`) instead
of constants; with the constants of those functions the bytes are theirs.

Beside each BAM the generator writes the records that the reference
needs (`<bam>.npz`): per alignment the transcript, position, reference
span and score, per read its number of alignments and the length of its
primary's SEQ, and the transcript lengths. The reference reads those,
never the BAM.
"""

from __future__ import annotations

import contextlib
import json
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)
NAME_LEN = 11  # 'r' + 9 digits + NUL
CIG = 12  # 3 ops: 12S spanM 9S
FIXED = 4 + 32 + NAME_LEN + CIG  # through the end of the cigar
AS_TAG = 7  # AS:i:<i32>
CLIP = 12 + 9  # soft clips around the match: a primary's SEQ is span + 21


def compress_payload(fhs, payload: np.ndarray, pool, level=1):
    """BGZF-compress a uint8 payload array in 64KB blocks on `pool`, into
    each of the files `fhs`."""
    mv = memoryview(payload.tobytes())
    blocks = [mv[i: i + 0xFF00] for i in range(0, len(mv), 0xFF00)]

    def one(b):
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        comp = co.compress(b) + co.flush()
        bsize = len(comp) + 12 + 6 + 8
        header = (
            b"\x1f\x8b\x08\x04" + b"\x00\x00\x00\x00" + b"\x00\xff"
            + struct.pack("<H", 6) + b"BC" + struct.pack("<H", 2)
            + struct.pack("<H", bsize - 1)
        )
        trailer = struct.pack("<II", zlib.crc32(b), len(b) & 0xFFFFFFFF)
        return header + comp + trailer

    for out in pool.map(one, blocks):
        for fh in fhs:
            fh.write(out)


def put_i32(buf, offs, vals):
    v = np.asarray(vals, dtype=np.int64)
    for k in range(4):
        buf[offs + k] = (v >> (8 * k)) & 0xFF


def put_u16(buf, offs, vals):
    v = np.asarray(vals, dtype=np.int64)
    buf[offs] = v & 0xFF
    buf[offs + 1] = (v >> 8) & 0xFF


def bam_header(t_len: np.ndarray) -> bytes:
    text = "@HD\tVN:1.6\tSO:unsorted\n@PG\tID:minimap2\tPN:minimap2\n"
    hdr = bytearray()
    hdr += b"BAM\x01"
    tb = text.encode()
    hdr += struct.pack("<i", len(tb)) + tb
    hdr += struct.pack("<i", len(t_len))
    for i in range(len(t_len)):
        nb = (b"t%06d" % i) + b"\x00"
        hdr += struct.pack("<i", len(nb)) + nb
        hdr += struct.pack("<i", int(t_len[i]))
    return bytes(hdr)


def barcode_of(cell: np.ndarray, bclen: int) -> np.ndarray:
    """[n, bclen] uint8: the barcode of each cell index, its base-4
    digits MSB first as ACGT."""
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    cell = np.asarray(cell, dtype=np.int64)
    digs = [(cell >> (2 * (bclen - 1 - k))) & 3 for k in range(bclen)]
    return lut[np.stack(digs, axis=-1)] if len(cell) else np.empty(
        (0, bclen), np.uint8)


def build_bam(path: Path, cfg: dict, seed: int, reads: int,
              chunk_reads: int = 100_000, threads: int = 4) -> dict:
    """Write the BAM of `reads` reads for the configuration `cfg` and its
    records (`<path>.npz`); returns counts of what was written.

    With `cfg["cells"]` absent it is `build_e2e_bam`: reads of ~mean_k
    alignments each, all alignments of a read sharing its span, zipf
    transcripts, the primary first and carrying SEQ. With `cells` it is
    `build_sc_bam`: `reads` in cell order, `reads / cells` a cell, each
    record with the CB tag of its cell."""
    rng = np.random.default_rng(seed)
    T = int(cfg["transcripts"])
    t_len = rng.integers(cfg["txp_len_min"], cfg["txp_len_max"],
                         size=T).astype(np.int64)
    single_cell = "cells" in cfg
    bclen = int(cfg.get("barcode_len", 0))
    reads_per_cell = reads // int(cfg["cells"]) if single_cell else 0
    tags = AS_TAG + (3 + bclen + 1 if single_cell else 0)

    n_pool = 8 << 20
    pool_bytes = (
        rng.integers(0, 4, size=n_pool) * 16 + rng.integers(0, 4, size=n_pool)
    ).astype(np.uint8)
    filler = None
    rec = {k: [] for k in ("tid", "pos", "span", "score")}
    sizes_all, seq_len_all = [], []

    with contextlib.ExitStack() as stack, ThreadPoolExecutor(threads) as tpool:
        fh = stack.enter_context(open(path, "wb"))
        compress_payload([fh], np.frombuffer(bam_header(t_len),
                                             np.uint8), tpool)
        for lo in range(0, reads, chunk_reads):
            hi = min(lo + chunk_reads, reads)
            n_r = hi - lo
            sizes = rng.geometric(1.0 / cfg["mean_alignments_per_read"],
                                  size=n_r).clip(
                1, cfg["max_alignments_per_read"])
            A = int(sizes.sum())
            read_idx = np.repeat(np.arange(lo, hi, dtype=np.int64), sizes)
            first = np.ones(A, dtype=bool)
            first[1:] = read_idx[1:] != read_idx[:-1]
            tid = (rng.zipf(cfg["zipf_a"], size=A) % T).astype(np.int64)
            span_r = rng.integers(cfg["span_min"], cfg["span_max"], size=n_r)
            span = np.repeat(span_r, sizes)
            tl = t_len[tid]
            room = np.maximum(tl - span, 1) if single_cell else tl - span
            pos = (rng.random(A) * room).astype(np.int64)
            score = span - rng.integers(0, cfg["score_drop_max"], size=A)
            l_seq = np.where(first, span + CLIP, 0).astype(np.int64)
            seq_bytes = (l_seq + 1) // 2 + l_seq
            rec_len = FIXED + seq_bytes + tags
            offs = np.zeros(A + 1, dtype=np.int64)
            np.cumsum(rec_len, out=offs[1:])
            # the seq+qual regions keep the pool-tiled filler; every
            # structured field is overwritten below
            need = int(offs[-1])
            if filler is None or len(filler) < need:
                filler = np.tile(pool_bytes, need // n_pool + 1)
            buf = filler[:need]
            o = offs[:-1]
            put_i32(buf, o, rec_len - 4)  # block_size
            put_i32(buf, o + 4, tid)
            put_i32(buf, o + 8, pos)
            buf[o + 12] = NAME_LEN
            buf[o + 13] = 60  # mapq
            put_u16(buf, o + 14, np.zeros(A, np.int64))  # bin
            put_u16(buf, o + 16, np.full(A, 3, np.int64))  # n_cigar
            put_u16(buf, o + 18, np.where(first, 0, 256))  # flag
            put_i32(buf, o + 20, l_seq)
            put_i32(buf, o + 24, np.full(A, -1, np.int64))
            put_i32(buf, o + 28, np.full(A, -1, np.int64))
            put_i32(buf, o + 32, np.zeros(A, np.int64))
            buf[o + 36] = ord("r")
            for k in range(9):
                buf[o + 37 + k] = (read_idx // 10 ** (8 - k)) % 10 + ord("0")
            put_i32(buf, o + 47, np.full(A, (12 << 4) | 4, np.int64))
            put_i32(buf, o + 51, (span.astype(np.int64) << 4) | 0)
            put_i32(buf, o + 55, np.full(A, (9 << 4) | 4, np.int64))
            to = offs[1:] - tags
            buf[to] = ord("A")
            buf[to + 1] = ord("S")
            buf[to + 2] = ord("i")
            put_i32(buf, to + 3, score)
            if single_cell:
                cb = to + AS_TAG
                buf[cb] = ord("C")
                buf[cb + 1] = ord("B")
                buf[cb + 2] = ord("Z")
                bc = barcode_of(read_idx // reads_per_cell, bclen)
                for k in range(bclen):
                    buf[cb + 3 + k] = bc[:, k]
                buf[cb + 3 + bclen] = 0
            compress_payload([fh], buf, tpool)
            rec["tid"].append(tid.astype(np.int32))
            rec["pos"].append(pos.astype(np.int32))
            rec["span"].append(span.astype(np.int32))
            rec["score"].append(score.astype(np.int32))
            sizes_all.append(sizes.astype(np.int32))
            seq_len_all.append((span_r + CLIP).astype(np.int32))
        fh.write(BGZF_EOF)
    arrays = {k: np.concatenate(v) for k, v in rec.items()}
    np.savez(str(path) + ".npz", sizes=np.concatenate(sizes_all),
             seq_len=np.concatenate(seq_len_all),
             t_len=t_len, reads_per_cell=np.int64(reads_per_cell),
             barcode_len=np.int64(bclen), **arrays)
    return {"reads": reads, "alignments": int(len(arrays["tid"])),
            "bytes": Path(path).stat().st_size}


def build_one(item: dict) -> dict:
    """One BAM of a plan (`python -m perfbench.gen`): written under a
    temporary name beside its path, with its records, and moved there
    when complete. The configuration is given whole or by name."""
    cfg = item["config"]
    if isinstance(cfg, str):
        here = Path(__file__).resolve().parent.parent
        with open(here / "configs" / f"{cfg}.json") as fh:
            cfg = json.load(fh)
    path = Path(item["path"])
    tmp = path.with_name(path.name + ".part")
    info = build_bam(tmp, cfg, int(item["seed"]), int(item["reads"]),
                     threads=int(item.get("threads", 4)))
    # on disk before the window: a write-back of the inputs would
    # otherwise land in it
    for f in (tmp, Path(str(tmp) + ".npz")):
        with open(f, "rb") as fh:
            os.fsync(fh.fileno())
    os.replace(str(tmp) + ".npz", str(path) + ".npz")
    os.replace(tmp, path)
    return info
