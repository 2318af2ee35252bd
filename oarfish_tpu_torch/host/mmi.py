"""Legacy minimap2 `.mmi` index container: parse + OTMI migration.

The reference reuses prebuilt indexes: its rammap backend loads both its
own RMMI format and legacy minimap2 `.mmi` files, using the index's own
k/w and recomputing the reference digest from the embedded sequences
when the oarfish footer is absent (`src/util/aligner.rs:78-131`). Our native mapper has its own OTMI format, but a
legacy `.mmi` that *embeds sequences* carries everything needed to
rebuild an OTMI automatically — so we parse the (publicly documented)
minimap2 container and migrate instead of bouncing the user back to the
FASTA. Sequence-stripped `.mmi` (built with minimap2's `--idx-no-seq`)
and rammap RMMI (format unobtainable offline) are rejected with a
precise description and a rebuild command.

Container layout (minimap2 `mm_idx_dump`/`mm_idx_load`, index.c):

  magic   4 bytes  "MMI\\x02"
  header  5 x u32  w, k, b, n_seq, flag
  per-sequence (n_seq times):
      u8 name_len, name bytes (0 under MM_I_NO_NAME), u32 seq_len
  buckets (1<<b times):
      i32 n;  n x u64 minimizer positions
      u32 size;  size x (u64 key, u64 val) hash entries
  sequences (absent under MM_I_NO_SEQ):
      ceil(total_len/8) x u32, 8 bases/word, 4 bits/base,
      base j of word w at bits 4*j (LSB-first); codes 0..3 = ACGT,
      >=4 = N. Per-sequence offsets are implicit (cumulative).

Flags: MM_I_HPC=0x1 (affects minimizers only; stored sequences are the
originals), MM_I_NO_SEQ=0x2, MM_I_NO_NAME=0x4.

All integers little-endian. We skip the minimizer buckets entirely —
the k-mer tables are rebuilt natively for OTMI; only names, lengths,
and sequences migrate.

Counterpart of the JAX package's `host/mmi.py` (host code, kept as a copy so this
package stands alone).
"""

from __future__ import annotations

import logging
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np

log = logging.getLogger("oarfish_tpu_torch")

MMI_MAGIC = b"MMI\x02"
MM_I_HPC = 0x1
MM_I_NO_SEQ = 0x2
MM_I_NO_NAME = 0x4

# 4-bit code -> base. Codes 4..15 are all "not ACGT" (minimap2 packs
# seq_nt4_table values, where every ambiguity code maps to 4).
_CODE2BASE = np.frombuffer(b"ACGT" + b"N" * 12, dtype=np.uint8)


class MmiFormatError(ValueError):
    """Raised when a purported .mmi file does not parse."""


@dataclass
class MmiIndex:
    w: int
    k: int
    bucket_bits: int
    flag: int
    names: List[str]
    lengths: List[int]
    seqs: Optional[List[bytes]]  # None when MM_I_NO_SEQ

    @property
    def has_sequences(self) -> bool:
        return self.seqs is not None

    def describe(self) -> str:
        traits = []
        if self.flag & MM_I_HPC:
            traits.append("homopolymer-compressed minimizers")
        if self.flag & MM_I_NO_SEQ:
            traits.append("sequence-stripped")
        if self.flag & MM_I_NO_NAME:
            traits.append("nameless")
        t = f" ({', '.join(traits)})" if traits else ""
        return (
            f"legacy minimap2 .mmi index: k={self.k} w={self.w} "
            f"n_seq={len(self.lengths)}{t}"
        )


def _read_exact(fh, n: int, what: str) -> bytes:
    buf = fh.read(n)
    if len(buf) != n:
        raise MmiFormatError(
            f"truncated .mmi: expected {n} bytes for {what}, "
            f"got {len(buf)}"
        )
    return buf


def unpack_seq4(words: np.ndarray, offset: int, length: int) -> bytes:
    """Decode `length` bases starting at global base offset `offset`
    from the 4-bit-packed u32 word array."""
    if length == 0:
        return b""
    idx = np.arange(offset, offset + length, dtype=np.int64)
    codes = (words[idx >> 3] >> ((idx & 7) << 2).astype(np.uint32)) & 0xF
    return _CODE2BASE[codes].tobytes()


def parse_mmi(path, *, skip_buckets: bool = True) -> MmiIndex:
    """Parse a legacy minimap2 .mmi container (names, lengths, and —
    when embedded — sequences). Minimizer buckets are skipped: OTMI
    rebuilds its own tables. Raises MmiFormatError on malformed input.
    """
    path = Path(path)
    with open(path, "rb") as fh:
        magic = _read_exact(fh, 4, "magic")
        if magic != MMI_MAGIC:
            raise MmiFormatError(
                f"{path}: not a legacy minimap2 .mmi (magic {magic!r})"
            )
        w, k, b, n_seq, flag = struct.unpack(
            "<5I", _read_exact(fh, 20, "header")
        )
        if not (0 < k <= 28 and 0 < w <= 255 and b <= 31):
            raise MmiFormatError(
                f"{path}: implausible .mmi header (w={w} k={k} b={b})"
            )
        if n_seq > 100_000_000:
            raise MmiFormatError(f"{path}: implausible n_seq={n_seq}")

        names: List[str] = []
        lengths: List[int] = []
        for i in range(n_seq):
            (nl,) = _read_exact(fh, 1, f"name length of seq {i}")
            if nl:
                names.append(
                    _read_exact(fh, nl, f"name of seq {i}").decode(
                        "utf-8", errors="replace"
                    )
                )
            else:
                names.append(f"seq{i}")
            (slen,) = struct.unpack(
                "<I", _read_exact(fh, 4, f"length of seq {i}")
            )
            lengths.append(slen)

        # buckets: 1<<b entries of (i32 n, n*u64, u32 size, size*2*u64)
        for i in range(1 << b):
            (n,) = struct.unpack(
                "<i", _read_exact(fh, 4, f"bucket {i} position count")
            )
            if n < 0:
                raise MmiFormatError(f"{path}: bucket {i} has n={n} < 0")
            fh.seek(8 * n, 1)
            (size,) = struct.unpack(
                "<I", _read_exact(fh, 4, f"bucket {i} hash size")
            )
            fh.seek(16 * size, 1)

        seqs: Optional[List[bytes]] = None
        if not (flag & MM_I_NO_SEQ):
            total = sum(lengths)
            n_words = (total + 7) // 8
            blob = _read_exact(fh, 4 * n_words, "packed sequence blob")
            words = np.frombuffer(blob, dtype="<u4")
            seqs = []
            off = 0
            for slen in lengths:
                seqs.append(unpack_seq4(words, off, slen))
                off += slen

    return MmiIndex(w, k, b, flag, names, lengths, seqs)


def write_mmi(
    path,
    names: List[str],
    seqs: List[bytes],
    *,
    w: int = 11,
    k: int = 15,
    bucket_bits: int = 2,
    no_seq: bool = False,
    no_name: bool = False,
    bucket_fill: int = 3,
) -> None:
    """Emit a syntactically valid legacy .mmi container (test fixture
    generator — the minimizer buckets are filled with deterministic
    dummy entries, which parse_mmi skips)."""
    flag = (MM_I_NO_SEQ if no_seq else 0) | (MM_I_NO_NAME if no_name else 0)
    lengths = [len(s) for s in seqs]
    with open(path, "wb") as fh:
        fh.write(MMI_MAGIC)
        fh.write(struct.pack("<5I", w, k, bucket_bits, len(seqs), flag))
        for name, slen in zip(names, lengths):
            if no_name:
                fh.write(b"\x00")
            else:
                nb = name.encode()
                fh.write(struct.pack("<B", len(nb)) + nb)
            fh.write(struct.pack("<I", slen))
        for i in range(1 << bucket_bits):
            n = bucket_fill + (i % 2)
            fh.write(struct.pack("<i", n))
            fh.write(struct.pack(f"<{n}Q", *range(i, i + n)))
            size = bucket_fill
            fh.write(struct.pack("<I", size))
            for j in range(size):
                fh.write(struct.pack("<2Q", 7919 * i + j, j))
        if not no_seq:
            total = sum(lengths)
            words = np.zeros((total + 7) // 8, dtype=np.uint32)
            base2code = np.full(256, 4, dtype=np.uint32)
            for c, v in zip(b"ACGT", range(4)):
                base2code[c] = v
                base2code[c + 32] = v  # lowercase
            off = 0
            for s in seqs:
                codes = base2code[np.frombuffer(s, dtype=np.uint8)]
                idx = np.arange(off, off + len(s), dtype=np.int64)
                np.bitwise_or.at(
                    words, idx >> 3,
                    codes << ((idx & 7) << 2).astype(np.uint32),
                )
                off += len(s)
            fh.write(words.astype("<u4").tobytes())
