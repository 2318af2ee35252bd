"""The benchmark's mode lines: a bulk run with bootstrap replicates, the
single-cell mode and genome read projection, each a user's whole run end
to end.

    python -m oarfish_tpu_torch.bench --e2e --boots N [--reps K]
    python -m oarfish_tpu_torch.bench --sc [--quick]
    python -m oarfish_tpu_torch.bench --genome [--reads N] [--genes G]

Counterparts of `scripts/bootstrap_e2e_bench.py`, `scripts/sc_e2e_bench.py`
and `scripts/genome_e2e_bench.py`, which sit beside the JAX package; this
module copies what it needs of them and imports none. Each prints one JSON
line with the script's metric name and keys, and some of the port's own.

`--e2e --boots N` (default 100 on `bench.ensure_bam`'s BAM of R = 2,000,000
reads, T = 200,000 transcripts, seed 0): the CLI's defaults with
`--num-bootstraps N --threads 4`, once cold and `--reps` (2) times warm:
`e2e_100boot_wall_s` (the warm median wall, the script's name whatever N),
`walls`, `replicates_written` (the columns of the run's `.infreps.pq`),
`per_replicate_s`; the port's `bootstrap_s` and iterations per
replicate from `quant/bulk.py`'s log line, the batch m-steps of the
replicates' pool (the span `boot.batches`), `cold`, `warm`,
`peak_rss_gb`, `impl`.

`--sc` (100,000 cells x 50 reads, T = 30,000; `--quick` 2,000 x 30 over
5,000): a CB-collated BAM (`build_sc_bam`, the script's bytes for the same
arguments, kept in the work directory and reused) through
`quantify_single_cell_from_collated_bam` with `--threads 4`:
`sc_e2e_cells_per_s` with `wall_s`, `cells`, `alignments`, `nnz`,
`peak_rss_gb`, `phases_s` (the `phase sc.*` log lines) and `gen_s`.

`--genome` (80,000 reads, 300 genes, seed 1): `scripts/rescue_eval.py`'s
spliced world and the script's reads (`build_world`, `simulate_reads`,
byte-equal for the same seed), then `python -m oarfish_tpu_torch --reads
--genome --annotation --seq-tech ont-cdna --threads 4 --junc-miss-discount
0.3` in a child process (on the card unless `--device` says otherwise):
`genome_e2e_wall_s` with `reads_per_s`, the child's `peak_rss_gb`, and
`spearman` / `mard` against the simulated truth (`evaluate`, in NumPy).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import logging
import os
import re
import signal
import struct
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from .bench import (
    BGZF_EOF,
    BenchRun,
    compress_payload,
    device_name,
    ensure_bam,
    logged,
    peak_rss_gb,
    put_i32,
    put_u16,
    run_once,
    work_dir,
)

REPO = Path(__file__).resolve().parent.parent
BCLEN = 16  # barcode length
SC = (100_000, 50, 30_000)  # cells, reads a cell, transcripts
SC_QUICK = (2_000, 30, 5_000)
GENOME = (80_000, 300)  # reads, genes
GENOME_TIMEOUT_S = 3000


# ---------------------------------------------------------------------------
# bulk with bootstrap replicates
# ---------------------------------------------------------------------------

def boots_bench(ns, device) -> BenchRun:
    """`scripts/bootstrap_e2e_bench.py`: the BAM through the CLI's defaults
    with `--num-bootstraps`, cold once (reported, not counted) and
    `--reps` times warm."""
    import pyarrow.parquet as pq

    extra = ["--num-bootstraps", str(ns.boots), "--threads", str(ns.threads)]
    with contextlib.ExitStack() as stack:
        work = work_dir(stack, ns.work_dir, "oarfish_boot_")
        bam, A, gen_s = ensure_bam(work, ns.reads, ns.txps, ns.seed)
        sys.stderr.write(f"boots: {bam} R={ns.reads} T={ns.txps} A={A} "
                         f"{ns.boots} replicates on {device}\n")
        out = work / "out"
        cold = run_once(bam, out, ns, extra)
        warms = sorted((run_once(bam, out, ns, extra)
                        for _ in range(ns.reps)), key=lambda r: r["wall_s"])
        written = len(pq.read_schema(str(out) + ".infreps.pq"))
    warm = warms[len(warms) // 2]
    walls = [round(r["wall_s"], 2) for r in warms]
    med = walls[len(walls) // 2]
    iters = warm["bootstrap_iterations"]
    line = {
        "metric": "e2e_100boot_wall_s",
        "value": med,
        "unit": (f"s BAM->quant+infreps (R={ns.reads}, T={ns.txps}, "
                 f"{ns.boots} bootstraps, impl={warm['impl']}, "
                 f"{device_name(device)}, warm median of {len(walls)}; "
                 f"cold={round(cold['wall_s'], 2)}s)"),
        "walls": walls,
        "replicates_written": written,
        "per_replicate_s": round(med / ns.boots, 3),
        "bootstrap_s": warm["bootstrap_s"],
        "bootstrap_iterations": iters,
        "bootstrap_msteps": warm["bootstrap_msteps"],
        "impl": warm["impl"],
        "peak_rss_gb": peak_rss_gb(),
        "R": ns.reads,
        "A": A,
        "threads": ns.threads,
        "cold": cold,
        "warm": warm,
        "gen_s": round(gen_s, 1),
        "seed": ns.seed,
    }
    return BenchRun(line)


# ---------------------------------------------------------------------------
# single cell
# ---------------------------------------------------------------------------

def build_sc_bam(path, C, reads_per_cell, T, seed=0, mean_k=2,
                 chunk_reads=100_000, threads=4):
    """CB-collated synthetic BAM: C cells x ~reads_per_cell reads,
    ~mean_k same-span alignments per read, zipf transcript popularity,
    16-base barcodes derived from the cell index. Reads are emitted in
    cell order, so the file is CB-collated as single-cell mode requires
    (`alignment_parser.rs:170-299` semantics). The bytes of
    `scripts/sc_e2e_bench.py::build_sc_bam` for the same arguments.
    Returns the number of alignment records."""
    rng = np.random.default_rng(seed)
    R = C * reads_per_cell
    t_len = rng.integers(400, 4000, size=T).astype(np.int64)
    text = "@HD\tVN:1.6\tSO:unsorted\n@PG\tID:minimap2\tPN:minimap2\n"
    hdr = bytearray()
    hdr += b"BAM\x01"
    tb = text.encode()
    hdr += struct.pack("<i", len(tb)) + tb
    hdr += struct.pack("<i", T)
    for i in range(T):
        nb = (b"t%06d" % i) + b"\x00"
        hdr += struct.pack("<i", len(nb)) + nb
        hdr += struct.pack("<i", int(t_len[i]))

    n_pool = 8 << 20
    pool_bytes = (
        rng.integers(0, 4, size=n_pool) * 16
        + rng.integers(0, 4, size=n_pool)
    ).astype(np.uint8)
    filler = None

    NAME_LEN = 11
    CIG = 12
    FIXED = 4 + 32 + NAME_LEN + CIG
    TAGS = 7 + 3 + BCLEN + 1  # AS:i:<i32> + CB:Z:<16>NUL
    CB_OFF = 7  # CB tag starts after AS

    base_lut = np.frombuffer(b"ACGT", dtype=np.uint8)

    total_alns = 0
    with open(path, "wb") as fh, ThreadPoolExecutor(threads) as tpool:
        harr = np.frombuffer(bytes(hdr), dtype=np.uint8)
        compress_payload(fh, harr, tpool)
        for lo in range(0, R, chunk_reads):
            hi = min(lo + chunk_reads, R)
            n_r = hi - lo
            sizes = rng.geometric(1.0 / mean_k, size=n_r).clip(1, 20)
            A = int(sizes.sum())
            total_alns += A
            read_idx = np.repeat(np.arange(lo, hi, dtype=np.int64), sizes)
            cell_idx = read_idx // reads_per_cell
            first = np.ones(A, dtype=bool)
            first[1:] = read_idx[1:] != read_idx[:-1]
            tid = (rng.zipf(1.3, size=A) % T).astype(np.int64)
            span_r = rng.integers(200, 380, size=n_r)
            span = np.repeat(span_r, sizes)
            tl = t_len[tid]
            pos = (rng.random(A) * np.maximum(tl - span, 1)).astype(
                np.int64
            )
            score = span - rng.integers(0, 10, size=A)
            l_seq = np.where(first, span + 21, 0).astype(np.int64)
            seq_bytes = (l_seq + 1) // 2 + l_seq
            rec_len = FIXED + seq_bytes + TAGS
            offs = np.zeros(A + 1, dtype=np.int64)
            np.cumsum(rec_len, out=offs[1:])
            need = int(offs[-1])
            if filler is None or len(filler) < need:
                filler = np.tile(pool_bytes, need // n_pool + 1)
            buf = filler[:need]
            o = offs[:-1]
            put_i32(buf, o, rec_len - 4)
            put_i32(buf, o + 4, tid)
            put_i32(buf, o + 8, pos)
            buf[o + 12] = NAME_LEN
            buf[o + 13] = 60
            put_u16(buf, o + 14, np.zeros(A, np.int64))
            put_u16(buf, o + 16, np.full(A, 3, np.int64))
            put_u16(buf, o + 18, np.where(first, 0, 256))
            put_i32(buf, o + 20, l_seq)
            put_i32(buf, o + 24, np.full(A, -1, np.int64))
            put_i32(buf, o + 28, np.full(A, -1, np.int64))
            put_i32(buf, o + 32, np.zeros(A, np.int64))
            buf[o + 36] = ord("r")
            for k in range(9):
                buf[o + 37 + k] = (
                    (read_idx // 10 ** (8 - k)) % 10 + ord("0")
                )
            put_i32(buf, o + 47, np.full(A, (12 << 4) | 4, np.int64))
            put_i32(buf, o + 51, (span.astype(np.int64) << 4) | 0)
            put_i32(buf, o + 55, np.full(A, (9 << 4) | 4, np.int64))
            to = offs[1:] - TAGS
            buf[to] = ord("A")
            buf[to + 1] = ord("S")
            buf[to + 2] = ord("i")
            put_i32(buf, to + 3, score)
            cb = to + CB_OFF
            buf[cb] = ord("C")
            buf[cb + 1] = ord("B")
            buf[cb + 2] = ord("Z")
            # 16 base-4 digits of the cell index, MSB first
            for k in range(BCLEN):
                dig = (cell_idx >> (2 * (BCLEN - 1 - k))) & 3
                buf[cb + 3 + k] = base_lut[dig]
            buf[cb + 3 + BCLEN] = 0
            compress_payload(fh, buf, tpool)
        fh.write(BGZF_EOF)
    return total_alns


def ensure_sc_bam(work: Path, C: int, reads_per_cell: int, T: int):
    """The single-cell BAM of this shape in `work`, built unless it and its
    record count are already there; returns (path, records, seconds spent
    building it)."""
    bam = work / f"oarfish_sc_C{C}_r{reads_per_cell}_T{T}.bam"
    meta = bam.with_suffix(".json")
    if bam.exists() and meta.exists():
        return bam, json.loads(meta.read_text())["A"], 0.0
    t0 = time.perf_counter()
    A = build_sc_bam(bam, C, reads_per_cell, T)
    gen_s = time.perf_counter() - t0
    meta.write_text(json.dumps({"A": A}))
    return bam, A, gen_s


class ScPhases(logging.Handler):
    """The `phase sc.<name> <seconds>` log lines of a single-cell run."""

    PHASE = re.compile(r"^phase (sc\.\w+) ([0-9.]+)")

    def __init__(self):
        super().__init__(level=logging.INFO)
        self.phases = {}

    def emit(self, record):
        m = self.PHASE.search(record.getMessage())
        if m:
            self.phases[m.group(1)] = round(float(m.group(2)), 2)


def mtx_nnz(path: Path):
    """The entry count on the size line of a MatrixMarket file, or None."""
    if not path.exists():
        return None
    with open(path) as fh:
        for line in fh:
            if not line.startswith("%"):
                return int(line.split()[2])
    return None


def sc_bench(ns, device) -> BenchRun:
    """`scripts/sc_e2e_bench.py`: the CB-collated BAM through
    `quantify_single_cell_from_collated_bam`."""
    from .cli import build_parser, to_args
    from .config import resolve_filters
    from .quant.single_cell import quantify_single_cell_from_collated_bam

    C, rpc, T = ns.cells, ns.reads_per_cell, ns.txps
    with contextlib.ExitStack() as stack:
        work = work_dir(stack, ns.work_dir, "oarfish_sc_")
        bam, A, gen_s = ensure_sc_bam(work, C, rpc, T)
        sys.stderr.write(f"sc: {bam} C={C} rpc={rpc} T={T} A={A} "
                         f"{bam.stat().st_size / 1e6:.0f}MB (gen "
                         f"{gen_s:.1f}s) on {device}\n")
        out = work / "sc_out"
        argv = ["--alignments", str(bam), "-o", str(out), "--single-cell",
                "--threads", str(ns.threads), "--em-dtype", "auto"]
        if ns.device is not None:
            argv += ["--device", ns.device]
        args = to_args(build_parser().parse_args(argv))
        opts = resolve_filters(args)
        cap = ScPhases()
        with logged(cap):
            t0 = time.perf_counter()
            quantify_single_cell_from_collated_bam(args, opts)
            wall = time.perf_counter() - t0
        nnz = mtx_nnz(Path(str(out) + ".count.mtx"))
    line = {
        "metric": "sc_e2e_cells_per_s",
        "value": round(C / wall, 1),
        "unit": (f"cells/s e2e (C={C}, rpc={rpc}, T={T}, A={A}, "
                 f"{device_name(device)})"),
        "wall_s": round(wall, 2),
        "cells": C,
        "alignments": A,
        "nnz": nnz,
        "peak_rss_gb": peak_rss_gb(),
        "phases_s": cap.phases,
        "gen_s": round(gen_s, 1),
    }
    return BenchRun(line)


# ---------------------------------------------------------------------------
# genome read projection
# ---------------------------------------------------------------------------

_U53 = 1.0 / 9007199254740992.0  # NumPy's double from a 64-bit draw
_BASES = b"ACGT"


def mutate(rng: np.random.Generator, seq: bytes, sub=0.03,
           indel=0.01) -> bytes:
    """`scripts/rescue_eval.py::mutate`, the same bytes and the same state
    of `rng` afterwards, without a Python step per base. That loop draws,
    per base, `r = rng.random()` (deleted below indel / 2, an inserted
    `rng.integers(4)` base below indel), then `rng.random() < sub` (a
    substituted `rng.integers(4)` base). A double takes one 64-bit draw of
    the PCG64 bit generator, `(u >> 11) * 2**-53`; `integers(4)` takes the
    top two bits of a 32-bit draw, the low half of a new 64-bit draw or the
    high half that the previous 32-bit draw left buffered (the generator's
    `has_uint32`). So a base without an event takes two draws in a row,
    and the scan here jumps from event to event: the pairs of draws whose
    first is below indel or whose second is below sub, at either parity of
    the stream."""
    bg = rng.bit_generator
    n = len(seq)
    start = bg.state
    buffered, upper = bool(start["has_uint32"]), int(start["uinteger"])
    raw = bg.random_raw(2 * n + n // 8 + 64)
    half = indel / 2

    def events(raw):
        d = (raw >> np.uint64(11)) * _U53
        ev = []
        for q in (0, 1):
            m = (len(d) - q) // 2
            hit = (d[q:q + 2 * m:2] < indel) | (d[q + 1:q + 2 * m:2] < sub)
            ev.append(np.flatnonzero(hit).tolist())
        return d, ev

    def base():
        nonlocal p, buffered, upper
        if buffered:
            buffered = False
            return _BASES[upper >> 30]
        u = int(raw[p])
        p += 1
        buffered, upper = True, u >> 32
        return _BASES[(u & 0xFFFFFFFF) >> 30]

    d, ev = events(raw)
    out = bytearray()
    p = i = 0
    while i < n:
        q, j = p & 1, p >> 1
        k = bisect.bisect_left(ev[q], j)
        # the bases before the next event, or all the pairs at hand
        stop = ev[q][k] if k < len(ev[q]) else (len(d) - q) // 2
        clean = min(stop - j, n - i)
        out += seq[i:i + clean]
        i += clean
        p += 2 * clean
        if i == n:
            break
        if k == len(ev[q]) or p + 4 > len(d):
            # out of draws before the event: take more
            raw = np.concatenate([raw, bg.random_raw(n + 64)])
            d, ev = events(raw)
            continue
        r = d[p]
        p += 1
        if r < half:
            i += 1
            continue
        if r < indel:
            out.append(base())
        s = d[p]
        p += 1
        out.append(base() if s < sub else seq[i])
        i += 1
    # leave the generator where the loop would have: p draws on, with the
    # same 32-bit half buffered
    bg.state = start
    bg.random_raw(p)
    state = bg.state
    state["has_uint32"], state["uinteger"] = int(buffered), upper
    bg.state = state
    return bytes(out)


def build_world(d: Path, rng, n_genes):
    """`scripts/rescue_eval.py::build_world`: G genes on one chromosome,
    each with isoform A = E1+E2+E3 and B = E1+E3; writes `anno.gtf` and
    `genome.fa`, returns ({isoform: sequence}, E1's length)."""
    e1, e2, e3, gap = 1200, 260, 1200, 1500
    glen = n_genes * (e1 + e2 + e3 + 3 * gap) + gap
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=glen)
    gtf_lines = []
    iso = {}
    pos = gap
    for g in range(n_genes):
        s1, e1e = pos + 1, pos + e1
        pos += e1 + gap
        s2, e2e = pos + 1, pos + e2
        pos += e2 + gap
        s3, e3e = pos + 1, pos + e3
        pos += e3 + gap
        a, b = f"G{g:03d}A", f"G{g:03d}B"
        for nm, exons in ((a, [(s1, e1e), (s2, e2e), (s3, e3e)]),
                          (b, [(s1, e1e), (s3, e3e)])):
            for s, e in exons:
                gtf_lines.append(
                    f'chr1\tt\texon\t{s}\t{e}\t.\t+\t.\t'
                    f'transcript_id "{nm}";'
                )
            iso[nm] = b"".join(
                genome[s - 1: e].tobytes() for s, e in exons
            )
    (d / "anno.gtf").write_text("\n".join(gtf_lines) + "\n")
    with open(d / "genome.fa", "w") as fh:
        fh.write(">chr1\n")
        gb = genome.tobytes().decode()
        for i in range(0, len(gb), 80):
            fh.write(gb[i: i + 80] + "\n")
    return iso, e1


def simulate_reads(d: Path, rng, iso, n_reads):
    """`scripts/genome_e2e_bench.py::simulate_reads`: reads drawn from a
    Dirichlet(0.8) abundance over the isoforms, each a random span of its
    isoform with 1 % substitutions and 0.5 % indels; writes `reads.fa` and
    `truth.tsv`, returns the true counts."""
    names = sorted(iso)
    truth = {nm: 0 for nm in names}
    p = rng.dirichlet(np.ones(len(names)) * 0.8)
    with open(d / "reads.fa", "w") as fh:
        for rid in range(n_reads):
            nm = names[int(rng.choice(len(names), p=p))]
            seq = iso[nm]
            span = int(rng.integers(min(400, len(seq) // 2), len(seq) + 1))
            pos = int(rng.integers(0, len(seq) - span + 1))
            frag = mutate(rng, seq[pos: pos + span], sub=0.01, indel=0.005)
            fh.write(f">r{rid}\n{frag.decode()}\n")
            truth[nm] += 1
    with open(d / "truth.tsv", "w") as fh:
        fh.write("name\tcount\n")
        for nm in names:
            fh.write(f"{nm}\t{truth[nm]}\n")
    return truth


def _columns(path, name_col: str, value_col: str):
    with open(path) as fh:
        head = fh.readline().rstrip("\n").split("\t")
        a, b = head.index(name_col), head.index(value_col)
        rows = [line.rstrip("\n").split("\t") for line in fh if line.strip()]
    return [r[a] for r in rows], [r[b] for r in rows]


def evaluate(quant_path, truth_path) -> dict:
    """`scripts/rescue_eval.py::evaluate` without pandas: the `.quant`
    rows joined to the truth on the name (in the `.quant`'s order),
    Spearman and MARD of the counts, to the same rounding."""
    from scipy import stats

    q_names, q_counts = _columns(quant_path, "tname", "num_reads")
    t_names, t_counts = _columns(truth_path, "name", "count")
    truth = dict(zip(t_names, t_counts))
    keep = [k for k, nm in enumerate(q_names) if nm in truth]
    x = np.array([float(q_counts[k]) for k in keep], dtype=np.float64)
    y = np.array([int(truth[q_names[k]]) for k in keep], dtype=np.int64)
    rho = float(stats.spearmanr(x, y)[0])
    denom = np.maximum(x + y, 1e-12)
    mard = float(np.mean(np.where(x + y > 0, np.abs(x - y) / denom, 0.0)))
    return {"spearman": round(rho, 4), "mard": round(mard, 4),
            "quantified": round(float(x.sum()), 1),
            "truth_total": int(y.sum())}


def genome_argv(d: Path, threads: int) -> list:
    """The script's command line for the world in `d`, without `-o`."""
    return ["--reads", str(d / "reads.fa"),
            "--genome", str(d / "genome.fa"),
            "--annotation", str(d / "anno.gtf"),
            "--seq-tech", "ont-cdna",
            "--threads", str(threads),
            # skip-junction reads tie their isoform pair without the
            # missed-junction discount (see scripts/rescue_eval.py)
            "--junc-miss-discount", "0.3"]


# Starts the command given after the output path, waits for it, writes its
# peak RSS (KiB) there and exits with its code: a process forked from the
# benchmark itself would count the benchmark's resident pages as its own
# (Linux keeps the largest RSS across fork and exec), a launcher's are few.
RSS_LAUNCHER = (
    "import os, subprocess, sys\n"
    "p = subprocess.Popen(sys.argv[2:])\n"
    "_, status, usage = os.wait4(p.pid, 0)\n"
    "open(sys.argv[1], 'w').write(str(usage.ru_maxrss))\n"
    "sys.exit(os.waitstatus_to_exitcode(status))\n"
)


def run_child(argv, cwd: Path, env: dict, log: Path, timeout: float):
    """`argv` in a child process, its output into `log`: (exit code,
    seconds, the child's own peak RSS in GB). The child runs under
    `RSS_LAUNCHER`, in a session of its own that is killed at `timeout`
    seconds."""
    rss = log.with_suffix(".rss")
    with open(log, "wb") as fh:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-c", RSS_LAUNCHER, str(rss), *argv], cwd=cwd,
            env=env, stdout=fh, stderr=subprocess.STDOUT,
            start_new_session=True)
        try:
            rc = proc.wait(timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            raise
        wall = time.perf_counter() - t0
    peak = round(int(rss.read_text()) / 1e6, 2) if rss.exists() else None
    return rc, wall, peak


def genome_bench(ns, device) -> BenchRun:
    """`scripts/genome_e2e_bench.py`: the spliced world and its reads,
    then the port's CLI on them in a child process."""
    from .host import mapper
    from .genome import project_native

    rng = np.random.default_rng(ns.seed)
    with contextlib.ExitStack() as stack:
        d = work_dir(stack, ns.work_dir, "oarfish_genome_")
        t0 = time.perf_counter()
        iso, _ = build_world(d, rng, ns.genes)
        truth = simulate_reads(d, rng, iso, ns.reads)
        gen_s = time.perf_counter() - t0
        # the mapper and the projection engine, built here once into the
        # package's build directory, where the child loads them from
        t0 = time.perf_counter()
        native = {"mapper": mapper.available(),
                  "project": project_native.available()}
        build_s = time.perf_counter() - t0
        sys.stderr.write(f"genome: {ns.genes} genes, {ns.reads} reads "
                         f"(gen {gen_s:.1f}s, native {native} "
                         f"{build_s:.1f}s) on {device}\n")
        env = dict(os.environ)
        env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get(
            "PYTHONPATH", "")
        argv = [sys.executable, "-m", "oarfish_tpu_torch",
                *genome_argv(d, ns.threads), "-o", str(d / "out"),
                "--quiet"]
        if ns.device is not None:
            argv += ["--device", ns.device]
        rc, wall, rss = run_child(argv, REPO, env, d / "child.log",
                                  GENOME_TIMEOUT_S)
        if rc != 0:
            tail = (d / "child.log").read_bytes()[-3000:]
            raise RuntimeError(f"genome run exited with {rc}: "
                               f"{tail.decode(errors='replace')}")
        acc = evaluate(d / "out.quant", d / "truth.tsv")
    line = {
        "metric": "genome_e2e_wall_s",
        "value": round(wall, 2),
        "unit": (f"s reads->quant in a child process (genome mode, "
                 f"{ns.genes} genes, {ns.reads} reads, "
                 f"{device_name(device)})"),
        "reads": ns.reads,
        "isoforms": 2 * ns.genes,
        "threads": ns.threads,
        "reads_per_s": round(ns.reads / wall, 1),
        "peak_rss_gb": rss,
        "spearman": acc["spearman"],
        "mard": acc["mard"],
        "truth_total": sum(truth.values()),
        "quantified": acc["quantified"],
        "gen_s": round(gen_s, 1),
        "native_build_s": round(build_s, 1),
        "native": native,
        "seed": ns.seed,
    }
    return BenchRun(line)
