#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

needs one CUDA device and fails without it. It builds every hand-written
kernel from the sources in this checkout, holds each against its plain
PyTorch version on the card, and drives the port's main paths (bulk
quantification of a transcriptome BAM, on one device, over read shards
and over two processes; single-cell quantification of a CB-collated BAM;
raw reads against a transcriptome and against a genome; a genome BAM;
the port's benchmark and its mode lines) at full width through the entry
points a user calls. One
JSON object per phase goes to standard output:

  env            card name and power limit, torch/CUDA versions, which
                 host helpers were built natively (all of them must be,
                 one g++ each, all started together; the mapper and the
                 projection engine loaded from the package's build
                 directory)
  kernels        the five kernel sources built (one nvcc each, all started
                 together), with build seconds
  k1_vs_plain    sorted-gather kernel vs its plain version on the bench
                 CSR (R=2,000,000 reads, T=200,000 transcripts, A~6M
                 alignments), its table the m-step's flat [T + 1]:
                 bit-equal for f32/f64 and 1/8 replicates, and to one
                 `index_select` of the same function; kernel, plain and
                 `index_select` times between CUDA events, and the
                 profiler's device time per launch of the kernel (warm,
                 L2 flushed, 8 replicates) and of `index_select` (1 and 8
                 replicates); the byte bound of the plan's one byte an
                 element, beside that of the earlier plan's 4-byte lane
                 and 1-byte flag; probes of what bounds it (all codes 0,
                 all rows pad, a memset of the output)
  k2_k3_k4_vs_plain  the routed (v4) plan of the same CSR, with its build
                 seconds and geometry and the seconds and bytes of its
                 composed source offsets; tile permute, route stage and
                 fused middle each bit-equal in f32 to its plain version at
                 the plan's shapes, the route stage in each variant (shared
                 memory for the expand stage, through L2 for the reduce
                 stage, f64, and a plan of 128-row chunks), the fused middle
                 also in f64 (its scratch area in device memory); kernel,
                 plain and (K2, K3) `index_select` times between CUDA
                 events, and the profiler's device time per launch of each
                 kernel (and of `index_select`), K2 for one tile and for 8
                 replicates; the byte bounds, for K2, K3 and K4 on the
                 bytes their composed offsets make them move, with the
                 bound of the int8 tables beside it. Then the
                 replicate-axis arms of the route stage and the fused
                 middle at 8 replicates: each bit-equal to its plain
                 version and to 8 launches without the axis, with the same
                 times and bounds (offsets once, values 8 times). Then the
                 fixed-order row sums of the glue: the transcript tail's
                 one launch (bucket sums, big transcripts' second level,
                 zero pad) and the read layout's table, f32 and f64,
                 alone and at 8 replicates, each launched again after
                 another batch, bit-equal to their plain version; the
                 tail timed against its bound and `index_add_`, with the
                 L2 cache warm and flushed before each launch
  em_full_width  the same CSR as an AlignmentStore through
                 `perform_inference_and_write_output` on the card, f32:
                 `--em-impl v4` with 8 bootstrap replicates (one batched
                 program: replicate 0 is held bit for bit against a serial
                 run with the same multiplicities), a second v4 run
                 (bit-identical, its plan out of the plan cache),
                 `--em-impl pallas` with 8 replicates, `--em-impl segsum`
  segsum_replicates  8 multinomial replicates of the segment-sum EM on
                 the bench CSR as one batch (`run_replicates`, the path of
                 `--em-impl segsum --num-bootstraps 8` and of process 0 of a
                 multi-process run) and as 8 single runs: seconds and
                 m-steps of each, every replicate of the batch with the
                 iterations and bits of its single run, the mass
  em_v3          the same store with `--em-impl v3`, f32, 8 bootstrap
                 replicates (one after another), then the SQUAREM runner
                 on the same device state: the host build's seconds, its geometry (NPAD,
                 chunks, Q, R1, R3) and the bytes of K2's composed
                 offsets; iterations, EM seconds, ms per iteration,
                 replicate seconds; exact launches (a sorted gather and
                 four tile permutes an m-step, nothing else); K1 on v3's
                 interleaved plan and K2 on each stage of both permutes
                 bit-equal to their plain versions, with event and device
                 times, the plain version's, `index_select`'s and the
                 bound; mass within 1e-5, L1/R < 2e-3 against the `segsum`
                 and `v4` runs of em_full_width; SQUAREM's iterations, EM
                 seconds and exact launches, the same iterations as the
                 segment-sum SQUAREM on the card and L1/R < 2e-3 to it
  cli_e2e        a collated BAM of the same scale through the CLI with
                 its defaults (cuda, auto -> v4), coverage model and
                 assignment probabilities on, three times: (a) with
                 OARFISH_PREBUILD=0 and a fresh plan cache, (b) with the
                 prebuild and another fresh cache, (c) again on (b)'s
                 cache, where the BAM's pointer file must give a prefetch
                 hit; `.quant`, `.ambig_info.tsv` and `.prob` byte-equal
                 across the three, each run's wall, pack, route build and
                 `prebuild.finish` seconds; then a smaller BAM through
                 the CLI with `--em-impl pallas`, and the sorted-gather
                 kernel against its plain version on that BAM's own plan
  covmodel_device_vs_host  the first CLI run's BAM packed again: the device
                 coverage model against the native host pass on that store
                 (rtol 1e-12), with both times
  cli_profile    the CLI's `--profile-dir` (a torch.profiler trace of the
                 whole run) on cli_e2e's two BAMs: the 1.7 GB one at the
                 defaults (auto -> v4, on run (c)'s plan cache) and the
                 smaller one with `--em-impl pallas`; outputs byte-equal
                 to the unprofiled twins, each hand-written kernel's
                 events in the trace as many as its launch counter
                 counted (one more run where they differ: both reported,
                 the phase fails if the second differs too), the names the
                 trace gives them, trace size, wall against the twin's,
                 and the card's busy share (kernels, and every device
                 activity) over the profiled span and over the EM's
  sharded       the read-sharded and multi-process EMs: (a) the bench
                 store through `perform_inference_and_write_output` with
                 `--em-impl v4 --num-shards 2` and 8 bootstrap replicates
                 (one batch), then `--num-shards 4` (the point EM), every
                 shard on this card: build seconds, iterations, EM
                 seconds, ms an iteration, peak device memory, exact
                 launches (D times a run's), mass within 1e-5, L1/R <
                 2e-3 against em_full_width's unsharded `v4`; one m-step
                 of each shard of the two-shard build, single and for 8
                 replicates, bit-equal through the kernels and through
                 their plain versions; (b) two processes of the CLI (gloo,
                 one card) on the cli_e2e BAM and (c) on its two halves
                 split on read boundaries (`{proc}`), `--em-impl segsum
                 --num-bootstraps 2` with the coverage model and
                 assignment probabilities, each against one in-process
                 run of the whole: L1/R < 2e-3, mass, `.ambig_info.tsv`
                 and `meta_info.json` equal, process 1 writes nothing
                 (or, in (c), only its `part1.prob`), the parts' reads
                 are the whole's, the 2 replicates carry the reads' mass
                 and in (b), where process 0 runs them alone, equal the
                 one-process run's; each process's wall, the all-reduces
                 and their share of the EM seconds
  bench          the port's benchmark in this process, `python -m
                 oarfish_tpu_torch.bench` with `v4` and with
                 OARFISH_BENCH_IMPL=pallas at the bench shape, then its
                 `--e2e --quick --reps 1`: the three JSON lines, exact
                 launches, the mass, each `ms_per_iter` between its
                 m-step alone and 5 times em_full_width's ms an iteration
  mode_bench     the JAX system's three mode benchmarks through the same
                 entry point: `--e2e --boots 100 --reps 1` on cli_e2e's
                 BAM (100 replicates on a pool of 8 slots; exact
                 launches over both runs, each replicate finite and
                 within 1e-5 of the reads kept, replicates 0, 96 and the
                 slowest bit-equal to single runs with their
                 multiplicities, one
                 batch m-step of 4 bit-equal through the kernels and
                 their plain versions), `--sc` (100,000 cells, dense, no
                 hand-written kernel; its BAM stays for single_cell) and
                 `--genome` (80,000 reads, 300 genes; the CLI in a child
                 process on the card, then the same command in this
                 process with exact K1 launches, each bit-equal to the
                 plain version, and outputs byte-equal to the child's):
                 the three JSON lines and the phase's seconds
  single_cell    a CB-collated BAM at `scripts/sc_e2e_bench.py`'s scale
                 (100,000 cells x 50 reads, T=30,000, ~2 alignments a
                 read; mode_bench's, `bench_modes.build_sc_bam`) through
                 the CLI with `--single-cell` on the card
                 (auto -> dense), then with OARFISH_SC_IMPL=segsum: wall
                 time, the sc.parse / sc.em / sc.write phases, cells/s,
                 buckets with their cells and sub-batches, peak device
                 memory; the matrix's mass within 1e-5 of the reads kept,
                 dense against segsum L1/R < 1e-6; two control runs of
                 dense, with TF32 allowed (L1/R printed) and with `prev`
                 rounded to bf16 each m-step (must exceed the limit); the
                 device time of one dense m-step at the most populous
                 bucket's shape
  raw_reads      a transcriptome at the size of
                 `scripts/rawreads_gencode_bench.py`'s defaults (250,000
                 transcripts, ~330 Mbp), in isoform families of three that
                 share exons; 80,000 reads of 10,000 expressed transcripts,
                 1 % substitutions, through
                 the CLI with its defaults on the card: `--annotated` with
                 `--index-out`, then `--index` (`.quant` and
                 `.ambig_info.tsv` byte-equal to the first run), then
                 `--index --em-impl segsum` (L1/R < 2e-3 against the
                 second); per run wall time, the mode's logged phase seconds
                 (index, map), the EM formulation, iterations, EM seconds
                 and their share of the wall, alignments, threads,
                 launches; the mass within 1e-5 of the reads kept; each
                 sorted gather of the run bit-equal to its plain version
                 on the run's own inputs
  genome_reads   a fifth of `scripts/genome_gencode_bench.py`'s genome
                 (25,000 two-isoform genes, 5 chromosomes, ~0.18 Gbp;
                 80,000 reads) through `--reads --genome --annotation`:
                 from the FASTA with `--index-out`, then from that index
                 (outputs byte-equal), then from that index with
                 `--em-impl segsum` (L1/R < 2e-3 against the second); the
                 same fields and checks
  genome_bam     the same reads as a name-collated genome BAM with their
                 true spliced alignments through `--genome-alignments
                 --annotation --genome-fasta` (rescue on); the same fields
                 and checks, its set-up phases (annotation, g2t index,
                 rescue database, flat g2t) logged by the driver
  em_breakdown   only with --breakdown: the `pallas` and the `v4` m-step
                 alone and the batched v4 m-step of 8 replicates, and the
                 loop with and without the host's per-iteration read of the
                 stop flag; the profile's launches and device time an
                 m-step, the m-steps of its window counted by a kernel
                 launched once each (K1 for `pallas`, K4 for `v4`)
  {"kernels": [...]}   per kernel: launches on the main path (in all and
                 per phase), error, times and bound
  <card name>, <power limit>
  {"ok": true, "device": {...}}

Each phase that drives the main path sets every kernel's launch count to 0
just before and reads the counts just after, and each count must be exact:
per m-step one sorted gather (`pallas`), or two tile permutes, two route
stages, one fused middle and one row sum (`v4`; four route stages, no
middle and a row sum more for a layout without a level table), with one
m-step per iteration plus the final one, per run
and per batch of bootstrap replicates: a batch runs to its slowest
replicate's count, all replicates in the same launches, which are counted
a second time as launches of the replicate-axis arms. Under `v3` an
m-step is one sorted gather and four tile permutes, for the run and for
each bootstrap replicate one after another. Over D shards every shard
launches a run's kernels (D times the counts). The single-cell
runs launch none of these kernels, and that is checked too. The raw-read
and genome runs end in the bulk tail: one sorted gather per m-step where
it takes `pallas` (as it does at their sizes), none under `segsum`.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import hashlib
import io
import json
import logging
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from oarfish_tpu_torch import bench as bench_mod
from oarfish_tpu_torch import bench_modes
from oarfish_tpu_torch.bench import (
    BGZF_EOF,
    build_e2e_bam,
    compress_payload,
    make_csr,
)
from oarfish_tpu_torch.cli import build_parser, main as cli_main, to_args
from oarfish_tpu_torch.config import Args, resolve_filters
from oarfish_tpu_torch.genome import project_native
from oarfish_tpu_torch.host import fmt_native, mapper, native
from oarfish_tpu_torch.host.filters import DiscardTable
from oarfish_tpu_torch.host.packer import pack_bam_fast
from oarfish_tpu_torch.host.store import (
    AlignmentStore,
    TranscriptCoverage,
    _get_cov_lib,
)
from oarfish_tpu_torch.kernels import build as kernel_build
from oarfish_tpu_torch.models import coverage as covmodel_host
from oarfish_tpu_torch.models import coverage_torch as covmodel_device
from oarfish_tpu_torch.ops import balance, em_dense, em_fast, em_v3, em_v4
from oarfish_tpu_torch.ops import bootstrap as bootstrap_ops
from oarfish_tpu_torch.ops import permute_plan, static_permute
from oarfish_tpu_torch.ops import route_middle as rm
from oarfish_tpu_torch.ops import route_stage as rs
from oarfish_tpu_torch.ops import row_sums as rsm
from oarfish_tpu_torch.ops import sorted_gather as sg
from oarfish_tpu_torch.ops import tile_permute as tp
from oarfish_tpu_torch.ops.bootstrap import (
    BOOT_BATCH,
    run_replicates,
    sample_multiplicities,
)
from oarfish_tpu_torch.ops.em import (
    EmData,
    replicate_step,
    run_em,
    run_em_squarem,
    uniform_init,
)
from oarfish_tpu_torch.ops.em_dense import DenseCellEm, _m_step_dense
from oarfish_tpu_torch.ops.em_fast import FastEmData
from oarfish_tpu_torch.ops.static_permute import GlobalRoute
from oarfish_tpu_torch.quant import bulk
from oarfish_tpu_torch.utils import trace
from oarfish_tpu_torch.quant.bulk import perform_inference_and_write_output

# the JAX package is named in the kernels line, never imported
JAX_PACKAGE = "oarfish_" + "tpu"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
FULL_READS, FULL_TXPS = 2_000_000, 200_000  # the bench shape
SMALL_READS = 500_000  # the second CLI run (`--em-impl pallas`)
# the single-cell phase: `scripts/sc_e2e_bench.py`'s defaults
SC_CELLS, SC_READS_PER_CELL, SC_TXPS = 100_000, 50, 30_000
# dense against segsum on the card, both f32: the two formulations add in
# other orders and read 2.4e-8 on this BAM; the limit sits between that
# and a dense run with `prev` rounded to bf16 (a control run of the phase)
SC_DENSE_VS_SEGSUM = 1e-6
# the raw-read phase: `scripts/rawreads_gencode_bench.py`'s defaults
RR_TXPS, RR_READS, RR_EXPRESSED = 250_000, 80_000, 10_000
# the genome phases: the read count of the reference's human-scale claim
# on a fifth of `scripts/genome_gencode_bench.py`'s genome (its 125,000
# genes over 25 chromosomes, cut to the time limit once `mode_bench`
# joined; chromosomes of the same size); the gene model (A = exons 1+2+3,
# B = exons 1+3) is the bench's
G_GENES, G_CHROMS, G_READS, G_SAMPLE_GENES = 25_000, 5, 80_000, 5_000
E1, E2, E3, GAP = 1200, 260, 1200, 1500
GENE_SPAN = E1 + E2 + E3 + 3 * GAP
DNA = np.frombuffer(b"ACGT", np.uint8)
# two EM formulations on the card, f32, against each other: v4 against
# segsum and pallas (em_full_width), pallas against segsum (raw_reads)
L1_OVER_R_LIMIT = 2e-3
EM_DENOM_THRESH = 1e-30

# name -> (its launch counter in `utils/trace.py`, CUDA source, the Pallas
# call or kernel arm it replaces in the JAX package). The replicate-axis
# arms of the route stage and the fused middle are entries of their own:
# their counter counts, of the wrapper's launches, those with a replicate
# axis.
KERNELS = {
    "sorted_gather": ("launch.sorted_gather", "sorted_gather.cu",
                      "ops/gather_pallas.py:156"),
    "tile_permute": ("launch.tile_permute", "tile_permute.cu",
                     "ops/static_permute.py:119"),
    "route_stage": ("launch.route_stage", "route_stage.cu",
                    "ops/static_permute.py:771"),
    "route_middle": ("launch.route_middle", "route_middle.cu",
                     "ops/static_permute.py:984"),
    "route_stage_replicates": ("launch.route_stage.replicate",
                               "route_stage.cu", "ops/static_permute.py:608"),
    "route_middle_replicates": ("launch.route_middle.replicate",
                                "route_middle.cu",
                                "ops/static_permute.py:782"),
    # not a Pallas kernel: the glue's row sums (XLA reductions there)
    "row_sums": ("launch.row_sums", "row_sums.cu", "ops/em_v4.py:1672"),
}
ARMS = ("route_stage_replicates", "route_middle_replicates")
# what the kernels line carries beside each kernel's event time
DEVICE_TIMES = ("device_ms", "library_device_ms", "variant", "moved_bytes",
                "table_bound_ms")
REPLICATES = 8  # one bootstrap batch


def reset_launch_counts() -> None:
    trace.reset("launch.")


def launch_counts() -> dict:
    return {name: trace.counter(counter)
            for name, (counter, _, _) in KERNELS.items()}


def variant_launches() -> dict:
    """The route stage's launches of each variant since the last reset."""
    return {v: trace.counter(f"launch.route_stage.{v}")
            for v in ("shared", "gather")}


def v4_launches(m_steps: int, fused: bool, batched_steps: int = 0) -> dict:
    """Launches of `m_steps` routed m-steps, `batched_steps` of them those
    of a batch of replicates on a layout that runs it as one program. The
    row sums: the transcript tail (both levels and the zero pad in one
    launch), and the read layout's where the middle is not fused."""
    return {"sorted_gather": 0, "tile_permute": 2 * m_steps,
            "route_stage": (2 if fused else 4) * m_steps,
            "route_middle": m_steps if fused else 0,
            "route_stage_replicates": 2 * batched_steps,
            "route_middle_replicates": batched_steps,
            "row_sums": (1 + int(not fused)) * m_steps}


T_START = time.time()


def emit(phase: str, **fields) -> None:
    """One phase's line; `at_s` is the script's seconds when it ends."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": round(time.time() - T_START, 1)}), flush=True)


# ---------------------------------------------------------------------------
# the raw-read and genome worlds: generators copied from
# `scripts/rawreads_gencode_bench.py` and `scripts/genome_gencode_bench.py`
# (their defaults; the genome one also writes each read's true alignment)
# ---------------------------------------------------------------------------

def build_transcriptome(d: Path, rng, n_txps: int):
    """`txps.fa`: isoform families of three over random bases, as the
    CPU tests make them (all four exons; exon 2 skipped; exon 3 skipped;
    the last family cut to `n_txps`), so that a read inside shared exons
    maps to two or three transcripts. The full isoform's length is
    log-normal, its exons split by Dirichlet(4, 4, 4, 4) fractions; the
    transcripts' mean is then ~1.3 kb as the raw-read bench's (~330 Mbp at
    250,000 transcripts)."""
    n_fam = (n_txps + 2) // 3
    full = np.clip(rng.lognormal(7.22, 0.55, n_fam), 400, 14_000)
    exons = np.maximum((rng.dirichlet(np.full(4, 4.0), n_fam)
                        * full[:, None]).astype(np.int64), 30)
    keep = (0, 1, 2, 3), (0, 2, 3), (0, 1, 3)
    lens = np.stack([exons[:, k].sum(1) for k in keep], 1).reshape(-1)
    lens = lens[:n_txps]
    offs = np.zeros(n_txps + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    unique = DNA[rng.integers(0, 4, int(exons.sum()))]
    ex_offs = np.zeros(exons.size + 1, np.int64)
    np.cumsum(exons.reshape(-1), out=ex_offs[1:])
    blob = np.empty(int(offs[-1]), np.uint8)
    with open(d / "txps.fa", "wb") as fh:
        for i in range(n_txps):
            f, k = divmod(i, 3)
            blob[offs[i]:offs[i + 1]] = np.concatenate(
                [unique[ex_offs[4 * f + e]:ex_offs[4 * f + e + 1]]
                 for e in keep[k]])
            fh.write(b">G%06d%s\n" % (f, b"abc"[k:k + 1]))
            fh.write(blob[offs[i]:offs[i + 1]].tobytes() + b"\n")
    return blob, offs, lens


def simulate_raw_reads(d: Path, rng, blob, offs, lens, n_reads: int,
                       n_expressed: int) -> np.ndarray:
    """`reads.fa`: fragments of Dirichlet(0.8)-weighted expressed
    transcripts with 1 % substitutions; returns the true counts."""
    expr = rng.choice(len(lens), size=n_expressed, replace=False)
    p = rng.dirichlet(np.ones(n_expressed) * 0.8)
    picks = expr[rng.choice(n_expressed, size=n_reads, p=p)]
    truth = np.zeros(len(lens), np.int64)
    with open(d / "reads.fa", "wb") as fh:
        for rid, t in enumerate(picks):
            t = int(t)
            L = int(lens[t])
            span = int(rng.integers(min(400, L // 2), L + 1))
            pos = int(rng.integers(0, L - span + 1))
            frag = blob[offs[t] + pos:offs[t] + pos + span].copy()
            m = rng.random(span) < 0.01
            nm = int(m.sum())
            if nm:
                frag[m] = DNA[rng.integers(0, 4, nm)]
            truth[t] += 1
            fh.write(b">r%d\n" % rid + frag.tobytes() + b"\n")
    return truth


def write_fasta_seq(fh, name: str, seq: np.ndarray, width: int = 80):
    """An 80-column FASTA record of a uint8 base array."""
    fh.write(b">" + name.encode() + b"\n")
    n = len(seq)
    nrows = (n + width - 1) // width
    pad = nrows * width - n
    mat = np.empty((nrows, width + 1), np.uint8)
    mat[:, width] = ord("\n")
    padded = np.empty(nrows * width, np.uint8)
    padded[:n] = seq
    if pad:
        padded[n:] = ord(" ")
    mat[:, :width] = padded.reshape(nrows, width)
    body = mat.reshape(-1).tobytes()
    if pad:
        body = body[: -(pad + 1)] + b"\n"
    fh.write(body)


def gene_coords(j: int):
    """Exons (start, end), 1-based inclusive, of gene j of a chromosome."""
    base = j * GENE_SPAN + GAP
    s1, e1 = base + 1, base + E1
    base += E1 + GAP
    s2, e2 = base + 1, base + E2
    base += E2 + GAP
    s3, e3 = base + 1, base + E3
    return (s1, e1), (s2, e2), (s3, e3)


def build_genome_world(d: Path, rng, n_genes: int, n_chroms: int,
                       sample_genes):
    """`genome.fa` and `anno.gtf`: n_genes two-isoform genes (A = exons
    1+2+3, B = exons 1+3) over n_chroms chromosomes of random bases.
    Returns the chromosomes' (names, lengths) and, for the sampled genes'
    isoforms, name -> (chromosome index, exons, sequence)."""
    per_chrom = (n_genes + n_chroms - 1) // n_chroms
    sampled = {}
    for g in sample_genes:
        sampled.setdefault(int(g) // per_chrom, []).append(int(g))
    isoforms, names, lengths = {}, [], []
    with open(d / "anno.gtf", "w") as gtf, open(d / "genome.fa", "wb") as fa:
        for c in range(n_chroms):
            g_lo = c * per_chrom
            ng = min(n_genes, g_lo + per_chrom) - g_lo
            if ng <= 0:
                break
            chrom = f"chr{c + 1}"
            clen = ng * GENE_SPAN + GAP
            names.append(chrom)
            lengths.append(clen)
            genome = DNA[rng.integers(0, 4, clen)]
            write_fasta_seq(fa, chrom, genome)
            lines = []
            for j in range(ng):
                ex = gene_coords(j)
                a, b = f"G{g_lo + j:06d}A", f"G{g_lo + j:06d}B"
                for nm, exons in ((a, ex), (b, (ex[0], ex[2]))):
                    for s, e in exons:
                        lines.append(f"{chrom}\tt\texon\t{s}\t{e}\t.\t+\t.\t"
                                     f'transcript_id "{nm}";')
            gtf.write("\n".join(lines) + "\n")
            for g in sampled.get(c, ()):
                ex = gene_coords(g - g_lo)
                for nm, exons in ((f"G{g:06d}A", ex),
                                  (f"G{g:06d}B", (ex[0], ex[2]))):
                    seq = np.concatenate([genome[s - 1:e] for s, e in exons])
                    isoforms[nm] = (c, exons, seq)
            del genome
    return names, lengths, isoforms


BAM_BASE_CODE = np.zeros(256, np.uint8)
for _i, _b in enumerate(b"=ACMGRSVTWYHKDBN"):
    BAM_BASE_CODE[_b] = _i


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    for shift, off in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        if beg >> shift == end >> shift:
            return off + (beg >> shift)
    return 0


def bam_record(name: bytes, ref_id: int, pos: int, cigar, seq: np.ndarray,
               score: int) -> bytes:
    """One mapped BAM record: `cigar` as [(length, op code)], `seq` uint8
    bases, an AS:i tag; no qualities."""
    codes = BAM_BASE_CODE[seq]
    if len(codes) % 2:
        codes = np.append(codes, 0)
    packed = (codes[0::2] << 4) | codes[1::2]
    ref_end = pos + sum(n for n, op in cigar if op in (0, 2, 3, 7, 8))
    rname = name + b"\x00"
    body = (
        struct.pack("<iiBBHHHiiii", ref_id, pos, len(rname), 60,
                    _reg2bin(pos, ref_end), len(cigar), 0, len(seq), -1, -1,
                    0)
        + rname
        + np.array([(n << 4) | op for n, op in cigar], "<u4").tobytes()
        + packed.astype(np.uint8).tobytes() + b"\xff" * len(seq)
        + b"ASi" + struct.pack("<i", score)
    )
    return struct.pack("<i", len(body)) + body


def simulate_genome_reads(d: Path, rng, isoforms, chroms, n_reads: int,
                          threads: int = 8) -> int:
    """`reads.fa` (Dirichlet(0.8) over the sampled isoforms, fragments with
    1 % substitutions, as the genome bench makes them) and `g.bam`, the
    same reads as a name-collated genome BAM with their true spliced
    alignments (M blocks, N introns) and AS = span - 2 x substitutions.
    Returns the BAM's size in bytes."""
    names = sorted(isoforms)
    p = rng.dirichlet(np.ones(len(names)) * 0.8)
    picks = rng.choice(len(names), size=n_reads, p=p)
    records = []
    with open(d / "reads.fa", "wb") as fh:
        for rid, k in enumerate(picks):
            chrom, exons, seq = isoforms[names[int(k)]]
            span = int(rng.integers(min(400, len(seq) // 2), len(seq) + 1))
            pos = int(rng.integers(0, len(seq) - span + 1))
            frag = seq[pos:pos + span].copy()
            m = rng.random(span) < 0.01
            nm = int(m.sum())
            if nm:
                frag[m] = DNA[rng.integers(0, 4, nm)]
            fh.write(b">r%d\n" % rid + frag.tobytes() + b"\n")
            # the fragment's genomic blocks through the exon chain
            blocks, t_off = [], 0
            for s, e in exons:
                a, b = max(pos, t_off), min(pos + span, t_off + e - s + 1)
                if a < b:
                    blocks.append((s - 1 + a - t_off, s - 1 + b - t_off))
                t_off += e - s + 1
            cigar = [(blocks[0][1] - blocks[0][0], 0)]
            for (_, e0), (s1, e1) in zip(blocks, blocks[1:]):
                cigar += [(s1 - e0, 3), (e1 - s1, 0)]
            records.append(bam_record(b"r%d" % rid, chrom, blocks[0][0],
                                      cigar, frag, span - 2 * nm))
    text = b"@HD\tVN:1.6\tSO:unsorted\n@PG\tID:minimap2\tPN:minimap2\n"
    hdr = bytearray(b"BAM\x01" + struct.pack("<i", len(text)) + text
                    + struct.pack("<i", len(chroms[0])))
    for name, length in zip(*chroms):
        nb = name.encode() + b"\x00"
        hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
    with open(d / "g.bam", "wb") as fh, ThreadPoolExecutor(threads) as pool:
        compress_payload(fh, np.frombuffer(bytes(hdr), np.uint8), pool)
        for lo in range(0, len(records), 20_000):
            compress_payload(fh, np.frombuffer(
                b"".join(records[lo:lo + 20_000]), np.uint8), pool)
        fh.write(BGZF_EOF)
    return (d / "g.bam").stat().st_size


def time_ms(fn, device, repeats: int = 10, batch: int = 10) -> float:
    """Median over `repeats` samples of the time of one `fn()` in ms, each
    sample a run of `batch` calls between two CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        torch.cuda.synchronize(device)
        times.append(a.elapsed_time(b) / batch)
    return float(np.median(times))


def queued_ms(fn, device, calls: int = 10) -> float:
    """Device time of one `fn()` in ms between CUDA events, the calls
    queued behind a kernel that keeps the card busy for about 0.1 s, so
    that it runs them back to back with no host time between them: a lower
    bound on any loop that calls `fn` once an iteration."""
    fn()
    torch.cuda.synchronize(device)
    torch.cuda._sleep(200_000_000)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    torch.cuda.synchronize(device)
    return a.elapsed_time(b) / calls


def kernel_equals_plain(tab, base, code, table_rows) -> float:
    """Launch the kernel and hold it bit for bit against its plain
    version; returns the largest absolute difference (0.0)."""
    got = sg.gather_rows_cuda(tab, base, code, table_rows)
    torch.cuda.synchronize(tab.device)
    want = sg.gather_rows_reference(tab, base, code, table_rows)
    assert got.shape == want.shape and got.dtype == want.dtype
    if not torch.equal(got, want):
        raise AssertionError(
            f"sorted_gather differs from its plain version "
            f"({tab.dtype}, table {tuple(tab.shape)}, {base.shape[0]} rows)"
        )
    return float((got - want).abs().max())


def k1_library(tab, base, code):
    """One `index_select` that computes K1's function: the table with a
    zero appended, and the flat index of every element, sent to that zero
    where it falls outside [0, n). Returns (padded table, index)."""
    n = tab.shape[-1]
    lane, hi = sg.unpack_code(code)
    idx = (base.unsqueeze(-1).long() + hi) * sg.LANES + lane
    idx = torch.where((idx >= 0) & (idx < n), idx, n).reshape(-1)
    return torch.nn.functional.pad(tab, (0, 1)), idx


def k1_bytes(base, code, n: int, table_rows: int, B: int = 1) -> dict:
    """The bytes K1's work moves in f32, each input read once and the output
    written once: in the kernel's form (one byte of code for each element
    of a row that is not all pad, 4 for each base, the flat table of n
    values once, the output), and in the plan's earlier form (a 4-byte lane
    and a 1-byte flag for every element, the table padded to S*128). The
    operations: an add and two compares an element."""
    n_rows = base.shape[0]
    live = int(((base + 1 >= 0) & (base < table_rows)).sum())
    L = n_rows * sg.LANES
    new = live * sg.LANES + n_rows * 4 + B * (L + n) * 4
    old = L * (4 + 1) + n_rows * 4 + B * (L + table_rows * sg.LANES) * 4
    return dict(live_rows=live, bytes_old_form=old,
                bound_ms_old_form=old / HBM_BYTES_PER_S * 1e3,
                **bound(new, 3 * L * B))


def bit_equal(name: str, got: torch.Tensor, want: torch.Tensor,
              against: str = "its plain version") -> float:
    """Hold a kernel's output bit for bit against its plain version's (or
    what `against` names); returns the largest absolute difference (0.0)."""
    torch.cuda.synchronize(got.device)
    assert got.shape == want.shape and got.dtype == want.dtype, name
    if not torch.equal(got, want):
        raise AssertionError(f"{name} differs from {against}")
    return float((got - want).abs().max())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


class SpanCapture(logging.Handler):
    """The span lines (`utils/trace.py`) of the port's log."""

    def __init__(self):
        super().__init__(level=logging.INFO)
        self.spans = []

    def emit(self, record):
        span = trace.parse(record.getMessage())
        if span is not None:
            self.spans.append(span)


@contextlib.contextmanager
def spans_logged():
    """The spans the port emits while the block runs."""
    handler = SpanCapture()
    logger = logging.getLogger("oarfish_tpu_torch")
    level = logger.level
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    try:
        yield handler.spans
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


# the spans of a v4 build's route tables, under the build profile's names
ROUTE_SPANS = {"route.fill": "finish.color_and_fill_tables",
               "route.upload": "finish.upload_tables"}


def build_phases(spans) -> dict:
    """Seconds of a v4 build's phases from its spans: `layout` and
    `finish`, each one's laps, and the route tables' fill (on its own
    thread, beside the finish's laps) and upload."""
    out = {}
    for span in spans:
        key = ROUTE_SPANS.get(span.name)
        if key is None and span.name.startswith(("v4.layout", "v4.finish")):
            key = span.name[len("v4."):]
        if key is not None:
            out[key] = round(span.seconds, 3)
    return out


class EmLogCapture(logging.Handler):
    """Collects (impl, iterations, seconds) from the log lines of
    `quant/bulk.py`, the bootstrap seconds and iterations, what `auto`
    resolved to, the route build seconds and the plan-cache hits."""

    EM = re.compile(r"(\w+) EM on \S+ \(\w+\) converged after (\d+) "
                    r"iterations in ([0-9.]+)s")
    BOOT = re.compile(r"(\d+) bootstrap replicates in ([0-9.]+)s, "
                      r"iterations \[([0-9, ]*)\]")
    AUTO = re.compile(r"em-impl auto -> (\w+)")
    ROUTING = re.compile(r"v4 routing built in ([0-9.]+)s")
    V3_ROUTING = re.compile(r"v3 routing built in ([0-9.]+)s")
    V3_LAYOUT = re.compile(r"v3 layout: NPAD (\d+), (\d+) chunks, "
                           r"Q (\d+) / (\d+), R1 (\d+) / (\d+), "
                           r"R3 (\d+) / (\d+)")
    LAYOUT = re.compile(r"v4 layout: (\d+) big transcripts, (\w+) middle")
    SC_PHASE = re.compile(r"phase (sc\.\w+) ([0-9.]+)")
    MODE_PHASE = re.compile(r"phase ((?:rawreads|genome)\.[\w.]+) ([0-9.]+)")
    RECORDS = re.compile(r"Total number of alignment records : (\d+)")
    SC_PARSED = re.compile(r"parsed (\d+) cells \((\d+) with no surviving "
                           r"alignments, (\d+) reads kept\)")
    SC_BUCKET = re.compile(r"sc bucket \((\d+), (\d+), (\d+)\): (\d+) cells, "
                           r"(\w+), (\d+) sub-batches of at most (\d+), "
                           r"([0-9.]+)s")
    SHARDED_BUILD = re.compile(r"sharded v4 routing built in ([0-9.]+)s "
                               r"\((\d+) shards")
    SHARDED_EM = re.compile(r"sharded-v4 EM on \S+ \(\w+\) converged after "
                            r"(\d+) iterations in ([0-9.]+)s")

    def __init__(self):
        super().__init__(level=logging.INFO)
        self.em = []
        self.boot = []
        self.auto = []
        self.routing = []
        self.layout = []
        self.v3_routing = []
        self.v3_layout = []
        self.prebuild = []
        self.prefetch_hits = 0
        self.sc = []
        self.mode_phases = []
        self.records = []
        self.cache_hits = 0
        self.warnings = []
        self.sharded = []

    def emit(self, record):
        msg = record.getMessage()
        m = self.EM.search(msg)
        if m:
            self.em.append((m.group(1), int(m.group(2)), float(m.group(3))))
        m = self.BOOT.search(msg)
        if m:
            self.boot.append((int(m.group(1)), float(m.group(2)),
                              [int(x) for x in m.group(3).split(",")]))
        m = self.AUTO.search(msg)
        if m:
            self.auto.append(m.group(1))
        m = self.ROUTING.search(msg)
        if m:
            self.routing.append(float(m.group(1)))
        m = self.LAYOUT.search(msg)
        if m:
            self.layout.append((int(m.group(1)), m.group(2) == "fused"))
        m = self.V3_ROUTING.search(msg)
        if m:
            self.v3_routing.append(float(m.group(1)))
        m = self.V3_LAYOUT.search(msg)
        if m:
            self.v3_layout.append([int(g) for g in m.groups()])
        span = trace.parse(msg)
        if span is not None and span.name == "prebuild.finish":
            self.prebuild.append(span.seconds)
        if "v4 plan prefetch hit" in msg:
            self.prefetch_hits += 1
        m = self.MODE_PHASE.search(msg)
        if m:
            self.mode_phases.append((m.group(1), float(m.group(2))))
        m = self.RECORDS.search(msg)
        if m:
            self.records.append(int(m.group(1)))
        for pattern in (self.SC_PHASE, self.SC_PARSED, self.SC_BUCKET):
            m = pattern.search(msg)
            if m:
                self.sc.append((pattern, m.groups()))
        for pattern in (self.SHARDED_BUILD, self.SHARDED_EM):
            m = pattern.search(msg)
            if m:
                self.sharded.append((pattern, m.groups()))
        if "v4 plan cache hit" in msg:
            self.cache_hits += 1
        if record.levelno >= logging.WARNING:
            self.warnings.append(msg)


def read_quant(path) -> np.ndarray:
    lines = Path(path).read_text().splitlines()
    assert lines[0].split("\t") == ["tname", "len", "num_reads"], lines[0]
    return np.array([float(ln.split("\t")[2]) for ln in lines[1:]])


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env() -> str:
    """Fails where a native host library did not build: the run would
    otherwise go through the slow NumPy / pure-Python paths and measure
    another program."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    loaders = {
        "bam_decoder": native.get_lib,
        "fmt": fmt_native.get_lib,
        "coverage": _get_cov_lib,
        "covmodel": covmodel_host._get_lib,
        "euler_color": permute_plan._get_color_lib,
        "balance": balance.get_lib,
        "mapper": mapper.get_lib,
        "projection": project_native.get_lib,
    }
    # one g++ per library, all started together
    t0 = time.time()
    with ThreadPoolExecutor(len(loaders)) as pool:
        libs = dict(zip(loaders, pool.map(lambda f: f(), loaders.values())))
    host_native = {k: lib is not None for k, lib in libs.items()}
    # the mapper and the projection engine come from this checkout's build
    # directory, never from beside the shared sources
    where = {k: Path(libs[k]._name).parent.name
             for k in ("mapper", "projection") if libs[k] is not None}
    emit(
        "env", card=smi, python=sys.version.split()[0],
        torch=torch.__version__, cuda=torch.version.cuda,
        host_native=host_native, host_build_wall_s=round(time.time() - t0, 2),
        host_build_seconds=dict(kernel_build.build_seconds),
        host_library_dirs=where,
    )
    missing = [k for k, ok in host_native.items() if not ok]
    if missing:
        raise RuntimeError(f"native host libraries did not build: {missing}")
    for k in where:
        assert (Path(libs[k]._name).resolve().parent
                == kernel_build.BUILD_DIR.resolve()), (k, libs[k]._name)
    return smi


def phase_kernels() -> None:
    sources = {source[:-3] for _, source, _ in KERNELS.values()}
    assert sources == set(kernel_build.CUDA_KERNELS)
    t0 = time.time()
    kernel_build.build_cuda_libraries()
    emit("kernels", kernels=sorted(sources),
         build_seconds={k: round(kernel_build.build_seconds[k], 3)
                        for k in sorted(sources)},
         build_wall_s=round(time.time() - t0, 3),
         nvcc=kernel_build.find_nvcc())


def phase_k1_vs_plain(csr, T, device) -> dict:
    """K1 on the bench CSR's `pallas` plan, its table the m-step's `[T +
    1]` (f32 / f64, 1 / 8 replicates), bit for bit against its plain
    version and one `index_select` computing the same function; event and
    device times (warm, with the L2 cache flushed before each launch, at 8
    replicates); and what bounds it: the same launch on the plan with
    every code 0 (the table reads fall on one value a row, so the stream
    of codes and outputs is what is left), on the plan with every row a
    pad row (the output alone), and a memset of the output."""
    txp_id, w, boundaries, A = csr
    t0 = time.time()
    data, _ = FastEmData.build(
        txp_id, w, boundaries, T, dtype=torch.float32,
        use_pallas_gather=True, device=device,
    )
    build_s = time.time() - t0
    assert data.use_pallas_gather, "gather plan was turned off"
    n_rows, S, n = data.g_rows, data.g_table_rows, T + 1
    L = n_rows * sg.LANES
    rng = np.random.default_rng(1)
    kernel = sg.gather_rows_cuda
    args = (data.g_p0, data.g_code, S)

    max_err = 0.0
    for dtype in (torch.float32, torch.float64):
        for B in (1, 8):
            shape = (n,) if B == 1 else (B, n)
            tab = torch.as_tensor(rng.random(shape), device=device).to(dtype)
            max_err = max(max_err, kernel_equals_plain(tab, *args))
            padded, idx = k1_library(tab, data.g_p0, data.g_code)
            bit_equal("index_select of K1's function",
                      padded.index_select(-1, idx),
                      kernel(tab, *args).reshape(*shape[:-1], L),
                      against="the kernel")

    # times at the main path's shapes: f32, one table and 8 replicates
    tab1 = torch.as_tensor(rng.random(n), device=device).float()
    tab8 = torch.as_tensor(rng.random((8, n)), device=device).float()
    pad1, idx = k1_library(tab1, data.g_p0, data.g_code)
    pad8 = torch.nn.functional.pad(tab8, (0, 1))
    flush = l2_flush(device)

    def cold():
        flush()
        kernel(tab1, *args)

    zero_codes = torch.zeros_like(data.g_code)
    all_pad = torch.full_like(data.g_p0, -2)
    out1 = torch.empty(L, device=device)
    # between events, 10 calls this short measure the host's time to launch
    # them; the profiler reads the card's own
    out = dict(
        A=A, n_rows=n_rows, table_rows=S, table_len=n, out_len=L,
        pad_share=round(1.0 - A / L, 4), layout_build_s=round(build_s, 2),
        bit_equal=True, max_abs_err=max_err,
        plan_bytes=nbytes(data.g_p0, data.g_code),
        ms=time_ms(lambda: kernel(tab1, *args), device),
        ms_b8=time_ms(lambda: kernel(tab8, *args), device),
        plain_ms=time_ms(lambda: sg.gather_rows_reference(tab1, *args),
                         device),
        library_ms=time_ms(lambda: pad1.index_select(0, idx), device),
        library_ms_b8=time_ms(lambda: pad8.index_select(1, idx), device),
        device_ms=device_ms(lambda: kernel(tab1, *args), device),
        device_ms_l2_flushed=device_ms(cold, device,
                                       only="sorted_gather_kernel"),
        device_ms_b8=device_ms(lambda: kernel(tab8, *args), device),
        library_device_ms=device_ms(lambda: pad1.index_select(0, idx),
                                    device),
        library_device_ms_b8=device_ms(lambda: pad8.index_select(1, idx),
                                       device),
        probe_device_ms=dict(
            codes_zero=device_ms(
                lambda: kernel(tab1, data.g_p0, zero_codes, S), device),
            all_pad=device_ms(
                lambda: kernel(tab1, all_pad, data.g_code, S), device),
            memset_output=device_ms(out1.zero_, device)),
        **k1_bytes(data.g_p0, data.g_code, n, S),
    )
    b8 = k1_bytes(data.g_p0, data.g_code, n, S, B=8)
    out.update(bytes_b8=b8["bytes"], bound_ms_b8=b8["bound_ms"],
               bound_ms_b8_old_form=b8["bound_ms_old_form"])
    emit("k1_vs_plain", **out)
    return out


def flat_index(reference, n: int, device) -> torch.Tensor:
    """The composed flat source index of a gather kernel: its plain
    version applied to 0..n-1 (f64 holds them exactly)."""
    iota = torch.arange(n, dtype=torch.float64, device=device)
    return reference(iota).reshape(-1).long()


def bound(n_bytes: int, n_ops: int, moved: Optional[int] = None) -> dict:
    """Least time for the work: every input read once and every output
    written once against the card's memory rate, or the operations against
    its f32 rate.

    `n_bytes` counts a routing's int8 tables, `moved` the same work done
    through the composed source offsets that the kernels read. The bound
    takes the fewer bytes of the two, so that no form of the work can beat
    it; `table_bound_ms` keeps the tables' figure, the one that earlier
    versions of the kernels were held to."""
    least = n_bytes if moved is None else min(n_bytes, moved)
    bytes_ms = least / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_OPS_PER_S * 1e3
    out = dict(bound_ms=max(bytes_ms, ops_ms), bytes=least, ops=n_ops,
               bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    if moved is not None:
        out.update(moved_bytes=moved, table_bytes=n_bytes,
                   table_bound_ms=max(n_bytes / HBM_BYTES_PER_S * 1e3,
                                      ops_ms))
    return out


def per_step(rows, once: Optional[str] = None,
             calls: Optional[int] = None) -> Optional[dict]:
    """A profiler window's kernel rows `(name, count, device_us)` per step.
    The window holds `calls` steps, or, with `once`, as many as the kernels
    whose name holds `once` (launched once a step) were counted: the
    profiler now and then drops a step's records, and the count of a
    once-a-step kernel says how many it kept. Every kernel's count must be a
    whole multiple of that number, or the window lost some of a step's
    records and the caller profiles again: None. Returns the steps, the
    launches and device ms a step, and by kernel the launches and device
    µs a step."""
    steps = calls
    if once is not None:
        steps = sum(count for name, count, _ in rows if once in name)
        if calls is not None and steps > calls:
            return None
    if not rows or not steps or any(count % steps for _, count, _ in rows):
        return None
    return dict(
        steps=steps,
        launches=sum(count for _, count, _ in rows) // steps,
        device_ms=sum(us for _, _, us in rows) / steps / 1e3,
        calls_per_step={name: count // steps for name, count, _ in rows},
        device_us_per_step={name: us / steps for name, _, us in rows})


def profile_rows(fn, device, calls: int) -> list:
    """`fn()` `calls` times under `torch.profiler`: the kernel rows
    `(name, count, device_us)` of the window (operator rows repeat their
    kernels' time and are left out, as is the step's own range). The
    window follows a warm-up window of as many calls, traced and dropped:
    windows that began with the tracer came back without their first
    launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize(device)
            prof.step()
    return [(e.key, e.count, e.device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0
            and not e.key.startswith("ProfilerStep")]


def profile_steps(fn, device, calls: int = 20, once: Optional[str] = None,
                  only: Optional[str] = None,
                  attempts: int = 8) -> Optional[dict]:
    """`per_step` of a window of `calls` calls of `fn` (the kernels whose
    name holds `only`, where given), profiled again until every kernel's
    count is a whole multiple of the steps, at most `attempts` times; None
    (not measured) where no window was whole."""
    fn()
    torch.cuda.synchronize(device)
    for _ in range(attempts):
        rows = [r for r in profile_rows(fn, device, calls)
                if only is None or only in r[0]]
        got = per_step(rows, once=once, calls=calls)
        if got is not None:
            return got
        logging.getLogger(__name__).warning(
            "the profiler's window is not whole (%d calls: %s); profiling "
            "again", calls, [(name[:40], count) for name, count, _ in rows])
    logging.getLogger(__name__).warning(
        "no whole profiler window in %d attempts: not measured", attempts)
    return None


def device_ms(fn, device, calls: int = 20, attempts: int = 8,
              only: Optional[str] = None):
    """Device time of one `fn()` in ms by `torch.profiler`: the kernels'
    own time on the card, without the host's time to launch them; with
    `only`, of the kernels whose name holds it.

    Now and then a profiling session drops records (CUPTI loses some or all
    of a window); a window whose kernel counts are not whole multiples of
    `calls` is profiled anew (`profile_steps`). Where no attempt gives a
    whole window the time is not measured (None): the event times and
    every check of the run stand without it."""
    got = profile_steps(fn, device, calls, only=only, attempts=attempts)
    return None if got is None else got["device_ms"]


def stage_variants_cr128(device) -> dict:
    """Both stages of a route of 64 chunks of 128 rows (the shared-memory
    variant in f32 and f64: the expand stage on tile-after-tile values, the
    reduce stage on the quota view), with `mul`, bit for bit against the
    plain version; and a batch of 3 against 3 launches without the axis."""
    rng = np.random.default_rng(3)
    n = 64 * 128 * rs.LANES
    n_data = int(n * 0.8)
    out_idx = np.sort(rng.choice(n, size=n_data, replace=False))
    in_idx = rng.permutation(n)[:n_data]
    plan = GlobalRoute(out_idx, in_idx, n, chunk_rows=128, device=device).plan
    ex, red = plan.expand_stage, plan.reduce_stage
    res = dict(Q=plan.Q, R1=plan.R1, R3=plan.R3, max_abs_err=0.0)
    for dtype in (torch.float32, torch.float64):
        rows = plan.n_src * 128
        x = torch.as_tensor(rng.normal(size=(3, rows, rs.LANES)),
                            device=device).to(dtype)
        mul = torch.as_tensor(rng.normal(size=(rows, rs.LANES)),
                              device=device).to(dtype)
        y = rs.route_stage_cuda(x, ex, mul)
        res["max_abs_err"] = max(
            res["max_abs_err"],
            bit_equal("route_stage cr128 expand", y, ex.reference(x, mul)),
            bit_equal("route_stage cr128 expand", y,
                      torch.stack([rs.route_stage_cuda(x[b], ex, mul)
                                   for b in range(3)]),
                      against="3 launches without the axis"))
        if plan.Q % rs.LANES == 0:
            q = plan.quota_view(y)
            res["max_abs_err"] = max(res["max_abs_err"], bit_equal(
                "route_stage cr128 reduce_strided",
                rs.route_stage_cuda(q, red), red.reference(q)))
        res[f"variants_{str(dtype)[6:]}"] = [
            rs.stage_variant(dtype, 128), rs.stage_variant(dtype, plan.R3)]
    return res


def phase_k2_k3_k4_vs_plain(csr, R, T, device) -> dict:
    """The three kernels of the routed iteration on the bench CSR's own
    plan, each against its plain version, f32, bit for bit."""
    txp_id, w, boundaries, A = csr
    cache = os.environ.get("OARFISH_PLAN_CACHE")
    os.environ["OARFISH_PLAN_CACHE"] = "0"  # time the build itself
    try:
        t0 = time.time()
        with spans_logged() as spans:
            data, order = em_v4.EmV4Data.build(
                txp_id, w, boundaries, T, device=device)
        torch.cuda.synchronize(device)
        build_s = time.time() - t0
    finally:
        if cache is None:
            del os.environ["OARFISH_PLAN_CACHE"]
        else:
            os.environ["OARFISH_PLAN_CACHE"] = cache
    pa, pb = data.p_a, data.p_b
    CR, L = pa.chunk_rows, rs.LANES
    fused = data.seg_id is not None
    strided = pa.Q % L == 0
    plan = dict(
        A=A, CR=CR, n_src=pa.n_src, n_dst=pa.n_dst, Q=pa.Q, R1=pa.R1,
        R3=pa.R3, t_rows=data.t_in.rows, max_lvl=data.max_lvl,
        n_big=data.n_big, fused_middle=fused, strided_exchange=strided,
        table_bytes=dict(
            p_a=nbytes(*pa.tables()), p_b=nbytes(*pb.tables()),
            t_in=nbytes(data.t_in.r1, data.t_in.r2, data.t_in.src,
                        data.t_in.lane),
            lvl=nbytes(data.seg_id)),
        build_s=round(build_s, 3),
        build_phases_s=build_phases(spans),
    )
    gen = torch.Generator(device="cpu").manual_seed(1)

    def values(*shape):
        # both signs, so that a wrong source cannot hide behind equal values
        return (torch.rand(*shape, generator=gen) - 0.3).to(device)

    res = {}

    # the source offsets the plan composed once per stage (on the card,
    # from the int8 tables), timed again here
    stages = dict(p_a_expand=pa.expand_stage, p_a_reduce=pa.reduce_stage,
                  p_b_expand=pb.expand_stage, p_b_reduce=pb.reduce_stage,
                  t_in=data.t_in.stage, t_out=data.t_out.stage)
    torch.cuda.synchronize(device)
    t0 = time.time()
    for st in stages.values():
        rs.Stage(st.r1, st.src, st.row, st.r2, st.mask, st.n_chunks, st.R_in,
                 st.R_out)
    torch.cuda.synchronize(device)
    plan["offsets"] = dict(
        build_s=time.time() - t0,
        bytes={k: nbytes(st.off) for k, st in stages.items()},
        dtype={k: str(st.off.dtype) for k, st in stages.items()})

    # K2: both tile permutes of the m-step, and one launch for a batch of 8
    k2 = {}
    for tag, t in (("t_in", data.t_in), ("t_out", data.t_out)):
        x = values(t.n_tiles * t.rows, L)
        args = (x, t.r1, t.r2, t.src, t.lane, t.rows, t.n_tiles)
        err = bit_equal(f"tile_permute {tag}",
                        tp.tile_permute_cuda(x, t.stage),
                        tp.tile_permute_reference(*args))
        idx = flat_index(lambda v: tp.tile_permute_reference(
            v.reshape(-1, L), *args[1:]), x.numel(), device)
        flat = x.reshape(-1)
        k2[tag] = dict(
            max_abs_err=err,
            ms=time_ms(lambda: tp.tile_permute_cuda(x, t.stage), device),
            plain_ms=time_ms(lambda: tp.tile_permute_reference(*args),
                             device, 5, 5),
            library_ms=time_ms(lambda: flat.index_select(0, idx), device),
            device_ms=device_ms(lambda: tp.tile_permute_cuda(x, t.stage),
                                device),
            library_device_ms=device_ms(lambda: flat.index_select(0, idx),
                                        device),
            **bound(nbytes(x, x, t.r1, t.r2, t.src, t.lane), 0,
                    moved=nbytes(x, x, t.stage.off)))
    t = data.t_in
    x8 = values(REPLICATES * t.n_tiles * t.rows, L)
    args8 = (x8, t.r1, t.r2, t.src, t.lane, t.rows, t.n_tiles, REPLICATES)
    err = max(
        bit_equal("tile_permute t_in x8",
                  tp.tile_permute_cuda(x8, t.stage, REPLICATES),
                  tp.tile_permute_reference(*args8)),
        bit_equal("tile_permute t_in x8",
                  tp.tile_permute_cuda(x8, t.stage, REPLICATES),
                  torch.cat([tp.tile_permute_cuda(part, t.stage)
                             for part in x8.chunk(REPLICATES)]),
                  against=f"{REPLICATES} launches without the axis"))
    flat8 = x8.reshape(REPLICATES, -1)
    idx = flat_index(lambda v: tp.tile_permute_reference(
        v.reshape(-1, L), *args[1:]), t.n_tiles * t.rows * L, device)
    k2["t_in_x8"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: tp.tile_permute_cuda(x8, t.stage, REPLICATES),
                   device),
        library_ms=time_ms(lambda: flat8.index_select(1, idx), device),
        device_ms=device_ms(
            lambda: tp.tile_permute_cuda(x8, t.stage, REPLICATES), device),
        library_device_ms=device_ms(lambda: flat8.index_select(1, idx),
                                    device),
        **bound(nbytes(x8, x8, t.r1, t.r2, t.src, t.lane), 0,
                moved=nbytes(x8, x8, t.stage.off)))
    res["tile_permute"] = k2
    del x8, flat8

    # K3: the expand stage with the weights (shared-memory variant), and
    # the reduce stage the plan takes (strided where the quota is whole lane
    # tiles; through L2)
    k3 = {}
    ex, red = pa.expand_stage, pb.reduce_stage
    x = values(pa.n_src * CR, L)
    w_txp = data.w_txp.reshape(-1, L)
    a1 = (x, pa.s1_r1, pa.s1_src, pa.s1_row, pa.s1_r2, None, pa.n_src, CR,
          pa.R1)
    y1 = rs.route_stage_cuda(x, ex, mul=w_txp)
    err = bit_equal("route_stage expand_y1", y1,
                    rs.route_stage_reference(*a1, mul=w_txp))
    idx_expand = flat_index(lambda v: rs.route_stage_reference(
        v.reshape(-1, L), *a1[1:]), x.numel(), device)
    flat = x.reshape(-1)
    k3["expand_y1_mul"] = dict(
        variant=rs.stage_variant(x.dtype, CR), max_abs_err=err,
        ms=time_ms(lambda: rs.route_stage_cuda(x, ex, mul=w_txp), device),
        plain_ms=time_ms(lambda: rs.route_stage_reference(*a1, mul=w_txp),
                         device, 5, 5),
        library_ms=time_ms(lambda: flat.index_select(0, idx_expand), device),
        device_ms=device_ms(lambda: rs.route_stage_cuda(x, ex, mul=w_txp),
                            device),
        library_device_ms=device_ms(lambda: flat.index_select(0, idx_expand),
                                    device),
        **bound(nbytes(x, w_txp, y1, pa.s1_r1, pa.s1_src, pa.s1_row,
                       pa.s1_r2), y1.numel(),
                moved=nbytes(x, w_txp, y1, ex.off)))
    yq = values(pb.n_src * pb.R1, L)
    if strided:
        tag, zq = "reduce_strided", pb.quota_view(yq)
    else:
        tag = "reduce"
        zq = yq.reshape(pb.n_src, pb.n_dst, pb.Q).transpose(0, 1)
        zq = zq.contiguous().reshape(pb.n_dst * pb.R3, L)
    a3 = (zq, pb.s3_r1, pb.s3_src, pb.s3_row, pb.s3_r2, pb.s3_mask,
          pb.n_dst, pb.R3, CR)
    out3 = rs.route_stage_cuda(zq, red)
    err = bit_equal(f"route_stage {tag}", out3,
                    rs.route_stage_reference(*a3))
    idx_reduce = flat_index(lambda v: rs.route_stage_reference(
        v.reshape(zq.shape), *a3[1:]), zq.numel(), device)
    flat = zq.reshape(-1)
    k3[tag] = dict(
        variant=rs.stage_variant(zq.dtype, pb.R3), max_abs_err=err,
        ms=time_ms(lambda: rs.route_stage_cuda(zq, red), device),
        plain_ms=time_ms(lambda: rs.route_stage_reference(*a3), device, 5, 5),
        library_ms=time_ms(lambda: flat.index_select(0, idx_reduce), device),
        device_ms=device_ms(lambda: rs.route_stage_cuda(zq, red), device),
        library_device_ms=device_ms(lambda: flat.index_select(0, idx_reduce),
                                    device),
        **bound(nbytes(zq, out3, pb.s3_r1, pb.s3_src, pb.s3_row, pb.s3_r2,
                       pb.s3_mask), 0, moved=nbytes(zq, out3, red.off)))
    # the other variants and types at the plan's shapes: f64 (the expand
    # stage through L2, 256 KB a chunk), f32 values that do not start on 16
    # bytes (the expand stage through L2 with int16 offsets), and both
    # stages of a plan of 128-row chunks (shared memory in f32 and f64)
    x64, w64 = x.double(), w_txp.double()
    k3["expand_y1_mul_f64"] = dict(
        variant=rs.stage_variant(torch.float64, CR),
        max_abs_err=bit_equal(
            "route_stage expand_y1 f64", rs.route_stage_cuda(x64, ex, w64),
            rs.route_stage_reference(x64, *a1[1:], mul=w64)))
    k3[f"{tag}_f64"] = dict(
        variant=rs.stage_variant(torch.float64, pb.R3),
        max_abs_err=bit_equal(
            f"route_stage {tag} f64", rs.route_stage_cuda(zq.double(), red),
            rs.route_stage_reference(zq.double(), *a3[1:])))
    del x64, w64
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=device)
    shifted = shifted[1:].view_as(x)
    shifted.copy_(x)
    k3["expand_y1_mul_unaligned"] = dict(
        variant=rs.stage_variant(x.dtype, CR, aligned=False),
        max_abs_err=bit_equal(
            "route_stage expand_y1 unaligned",
            rs.route_stage_cuda(shifted, ex, w_txp), y1))
    del shifted
    k3["cr128"] = stage_variants_cr128(device)
    res["route_stage"] = k3

    # K4: the fused middle on the expand stage's own output, without and
    # with bootstrap multiplicities. It reads the source offsets of route
    # A's reduce stage and route B's expand stage, fewer bytes than the int8
    # tables (read once) that its bound counted before: `bound_ms` is the
    # offsets' figure, `table_bound_ms` the tables'
    k4 = {}
    if fused:
        zg = pa.quota_view(y1) if strided else (
            y1.reshape(pa.n_src, pa.n_dst, pa.Q).transpose(0, 1)
            .contiguous().reshape(pa.n_dst * pa.R3, L))
        rng = np.random.default_rng(2)
        mult = torch.as_tensor(
            rng.multinomial(R, np.full(R, 1.0 / R))[order],
            device=device).float()
        tables = (pa.s3_r1, pa.s3_src, pa.s3_row, pa.s3_r2, pa.s3_mask,
                  pb.s1_r1, pb.s1_src, pb.s1_row, pb.s1_r2)
        st_a, st_b = pa.reduce_stage, pb.expand_stage
        am = (zg, data.seg_id, st_a, st_b, EM_DENOM_THRESH, data.max_lvl)
        n_c = pa.n_dst * CR * L
        variant = rm.middle_variant(zg.dtype, CR, data.max_lvl)
        for tag, m in (("point", None),
                       ("replicate", em_v4.mult_slots(data, mult))):
            got = rm.route_middle_cuda(*am, mult=m)
            err = bit_equal(f"route_middle {tag}", got,
                            rm.route_middle_reference(*am, mult=m))
            assert torch.isfinite(got).all()
            k4[tag] = dict(
                variant=variant, max_abs_err=err,
                ms=time_ms(lambda: rm.route_middle_cuda(*am, mult=m), device),
                device_ms=device_ms(
                    lambda: rm.route_middle_cuda(*am, mult=m), device),
                plain_ms=time_ms(
                    lambda: rm.route_middle_reference(*am, mult=m),
                    device, 3, 3),
                library_ms=None,
                # an add, a product (two for a replicate) and a share of a
                # division per chunk element
                **bound(nbytes(zg, got, data.seg_id, m, *tables),
                        (3 if m is None else 4) * n_c,
                        moved=nbytes(zg, got, data.seg_id, m, st_a.off,
                                     st_b.off)))
        # f64 at the plan's shapes: the chunk does not fit a block's shared
        # memory and goes through the scratch area in device memory
        zg64 = zg.double()
        m64 = em_v4.mult_slots(data, mult).double()
        k4["point_f64"] = dict(max_abs_err=max(
            bit_equal(f"route_middle f64{tag}",
                      rm.route_middle_cuda(zg64, *am[1:], mult=m),
                      rm.route_middle_reference(zg64, *am[1:], mult=m))
            for tag, m in (("", None), (" with mult", m64))))
        del zg64, m64
    res["route_middle"] = k4

    # The replicate-axis arms at one bootstrap batch: values (and `mult`)
    # with a leading axis of 8, tables, level table and `mul` shared. Each
    # is held bit for bit against its plain version and against 8 launches
    # without the axis. Bound: offsets (or tables) once, values 8 times.
    # Library: 8 `index_select`s with the composed index.
    if not (fused and strided):
        raise RuntimeError(
            "the bench plan does not take the fused middle with the strided "
            "exchange: the replicate arms have no path to be measured on")
    B = REPLICATES

    def each(fn):
        return torch.stack([fn(b) for b in range(B)])

    def both(name, got, plain, single):
        return max(bit_equal(name, got, plain),
                   bit_equal(name, got, each(single),
                             against=f"{B} launches without the axis"))

    arm3 = {}
    x8 = values(B, pa.n_src * CR, L)
    a1b = (x8, *a1[1:])
    y8 = rs.route_stage_cuda(x8, ex, mul=w_txp)
    err = both("route_stage expand_y1 x8", y8,
               rs.route_stage_reference(*a1b, mul=w_txp),
               lambda b: rs.route_stage_cuda(x8[b], ex, mul=w_txp))
    flat8 = x8.reshape(B, -1)
    arm3["expand_y1_mul"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: rs.route_stage_cuda(x8, ex, mul=w_txp), device),
        plain_ms=time_ms(lambda: rs.route_stage_reference(*a1b, mul=w_txp),
                         device, 3, 3),
        library_ms=time_ms(
            lambda: [flat8[b].index_select(0, idx_expand) for b in range(B)],
            device),
        library_device_ms=device_ms(
            lambda: [flat8[b].index_select(0, idx_expand) for b in range(B)],
            device),
        device_ms=device_ms(lambda: rs.route_stage_cuda(x8, ex, mul=w_txp),
                            device),
        **bound(nbytes(x8, w_txp, y8, pa.s1_r1, pa.s1_src, pa.s1_row,
                       pa.s1_r2), y8.numel(),
                moved=nbytes(x8, w_txp, y8, ex.off)))
    yq8 = values(B, pb.n_src * pb.R1, L)
    a3b = (pb.quota_view(yq8), *a3[1:])
    out8 = rs.route_stage_cuda(a3b[0], red)
    err = both("route_stage reduce_strided x8", out8,
               rs.route_stage_reference(*a3b),
               lambda b: rs.route_stage_cuda(pb.quota_view(yq8[b]), red))
    flat8 = yq8.reshape(B, -1)
    arm3["reduce_strided"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: rs.route_stage_cuda(a3b[0], red), device),
        plain_ms=time_ms(lambda: rs.route_stage_reference(*a3b), device, 3, 3),
        library_ms=time_ms(
            lambda: [flat8[b].index_select(0, idx_reduce) for b in range(B)],
            device),
        library_device_ms=device_ms(
            lambda: [flat8[b].index_select(0, idx_reduce) for b in range(B)],
            device),
        device_ms=device_ms(lambda: rs.route_stage_cuda(a3b[0], red), device),
        **bound(nbytes(yq8, out8, pb.s3_r1, pb.s3_src, pb.s3_row, pb.s3_r2,
                       pb.s3_mask), 0, moved=nbytes(yq8, out8, red.off)))
    res["route_stage_replicates"] = arm3
    del x8, yq8, out8, flat8

    arm4 = {}
    zg8 = pa.quota_view(y8)
    mult8 = torch.as_tensor(
        rng.multinomial(R, np.full(R, 1.0 / R), size=B)[:, order],
        device=device).float()
    am8 = (zg8, *am[1:])
    for tag, m in (("point", None),
                   ("replicate", em_v4.mult_slots(data, mult8))):
        got = rm.route_middle_cuda(*am8, mult=m)
        err = both(
            f"route_middle {tag} x8", got,
            rm.route_middle_reference(*am8, mult=m),
            lambda b: rm.route_middle_cuda(
                zg8[b], *am[1:], mult=None if m is None else m[b]))
        assert torch.isfinite(got).all()
        arm4[tag] = dict(
            variant=variant, max_abs_err=err,
            ms=time_ms(lambda: rm.route_middle_cuda(*am8, mult=m), device),
            device_ms=device_ms(lambda: rm.route_middle_cuda(*am8, mult=m),
                                device),
            plain_ms=time_ms(
                lambda: rm.route_middle_reference(*am8, mult=m), device, 2, 2),
            library_ms=None,
            **bound(nbytes(zg8, got, data.seg_id, m, *tables),
                    (3 if m is None else 4) * n_c * B,
                    moved=nbytes(zg8, got, data.seg_id, m, st_a.off,
                                 st_b.off)))
    res["route_middle_replicates"] = arm4
    res["row_sums"] = row_sums_vs_plain(data, values, device)
    emit("k2_k3_k4_vs_plain", plan=plan, bit_equal=True, replicates=B, **res)
    return dict(plan=plan, **res)


def slot_outputs(table, n_in: int) -> np.ndarray:
    """The output each of `n_in` values is added to under a row-sum
    table, -1 for a value no entry reads (gaps between buckets, the
    tail)."""
    idx = np.full(n_in, -1, dtype=np.int64)
    ends = np.append(table.entries[1:, 0], table.n_out)
    for (off, base, K, W), end in zip(table.entries.tolist(), ends.tolist()):
        count = end - off
        q = off + np.arange(count, dtype=np.int64).reshape(count // W, 1, W)
        idx[base : base + count * K] = np.broadcast_to(
            q, (count // W, K, W)).reshape(-1)
    return idx


def tail_index(plan, n_t: int, device) -> torch.Tensor:
    """The index of one `index_add_` that computes the transcript tail
    (bucket sums, then each big transcript's rows summed, zero pad): every
    slot mapped straight to its small-bucket row or its big transcript,
    the slots that no sum reads to a dump output after the last. Made
    once per layout, like the kernel's plan."""
    out = slot_outputs(plan.table, n_t)
    hi = out >= plan.first
    rows = out[hi] - plan.first
    group = np.searchsorted(plan.offsets, rows, side="right") - 1
    out[hi] = np.where(rows < plan.offsets[-1], plan.first + group, -1)
    out[out < 0] = plan.n_out
    return torch.as_tensor(out, device=device)


def l2_flush(device):
    """A function that overwrites 128 MB, more than the card's 50 MB L2
    cache, so that the next kernel reads its inputs from device memory."""
    scrub = torch.empty(2**25, dtype=torch.float32, device=device)
    return scrub.zero_


def row_sums_vs_plain(data, values, device) -> dict:
    """The row-sum kernel on the bench plan: the transcript tail's one
    launch (bucket sums, big transcripts' second level, zero pad) and the
    read layout's table, f32 and f64, alone and at 8 replicates, and
    alone again after the batch, bit for bit against its plain version;
    the tail timed against its bound and one `index_add_`, alone and at 8
    replicates, its device time also with the L2 cache flushed before
    each launch (as the m-step finds it)."""
    B = REPLICATES
    CR, L = data.p_a.chunk_rows, rs.LANES
    tail, rd = data.tail_plan, data.read_sum_table.plan
    n_t, n_r = data.p_a.n_src * CR * L, data.p_a.n_dst * CR * L
    err = 0.0
    for tag, plan, n in (("tail", tail, n_t), ("read", rd, n_r)):
        for dtype in (torch.float32, torch.float64):
            for shape in ((n,), (B, n), (n,)):
                x = values(*shape).to(dtype)
                want = rsm.plan_reference(x, plan)
                for _ in range(2):
                    err = max(err, bit_equal(
                        f"row_sums {tag} {shape} {dtype}",
                        rsm.row_sums_cuda(x, plan), want))

    # the library's one call for the same function: `index_add_` of every
    # slot into its output (atomic adds: timed and held close, not to bits)
    idx = tail_index(tail, n_t, device)

    def library(x):
        return x.new_zeros((*x.shape[:-1], tail.n_out + 1)).index_add_(
            -1, idx, x)[..., : tail.n_out]

    flush = l2_flush(device)
    out = dict(plan=dict(tiles=len(tail.tiles), groups=len(tail.groups),
                         values_read=tail.values_read, outputs=tail.n_out,
                         read_tiles=len(rd.tiles)),
               max_abs_err=err, launches_per_m_step=1)
    for tag, reps in (("single", 1), ("x8", B)):
        x = values(*((n_t,) if reps == 1 else (reps, n_t)))
        want, lib = rsm.row_sums_cuda(x, tail), library(x)
        lib_err = float((lib - want).abs().max())
        assert lib_err <= 1e-4 * float(want.abs().max()), (
            f"index_add_ yardstick differs from the kernel by {lib_err}")

        def cold():
            flush()
            rsm.row_sums_cuda(x, tail)

        m = dict(
            ms=time_ms(lambda: rsm.row_sums_cuda(x, tail), device),
            device_ms=device_ms(lambda: rsm.row_sums_cuda(x, tail), device),
            device_ms_l2_flushed=device_ms(cold, device,
                                           only="row_sums_kernel"),
            plain_ms=time_ms(lambda: rsm.plan_reference(x, tail), device,
                             2, 1),
            library_ms=time_ms(lambda: library(x), device),
            library_device_ms=device_ms(lambda: library(x), device),
            library_max_abs_err=lib_err,
            **bound(nbytes(tail.device_tiles, tail.device_groups)
                    + x.element_size() * reps
                    * (tail.values_read + tail.n_out),
                    reps * tail.values_read))
        if tag == "single":
            out.update(m)
        else:
            out.update({f"{k}_8_replicates": v for k, v in m.items()})
    return out


def bench_store(csr, R, T):
    """The bench CSR as an AlignmentStore, with names, lengths and a
    coverage table for `perform_inference_and_write_output`."""
    txp_id, w, boundaries, A = csr
    store = AlignmentStore(
        txp_id=txp_id,
        start=np.ones(A, dtype=np.int64),
        end=np.full(A, 1000, dtype=np.int64),
        as_prob=w,
        cov_prob=np.ones(A, dtype=np.float64),
        boundaries=boundaries,
        discard=DiscardTable(valid_best_aln=R),
        num_unique_alignments=int((np.diff(boundaries) == 1).sum()),
    )
    names = [f"t{i:06d}" for i in range(T)]
    lens = np.full(T, 2000, dtype=np.int64)
    return store, names, lens, TranscriptCoverage(lens, 0)


def phase_em_full_width(csr, R, T, device, tmp: Path, capture, fused: bool):
    """Returns (the phase's line, launches per kernel in the phase, the
    counts of each run)."""
    txp_id, w, boundaries, A = csr
    store, names, lens, coverage = bench_store(csr, R, T)

    def run(tag, impl, boots):
        args = Args(
            output=tmp / tag, em_impl=impl, em_dtype="float32",
            num_bootstraps=boots, seed=0,
        )
        opts = resolve_filters(args)
        n_em, n_boot = len(capture.em), len(capture.boot)
        n_route, hits = len(capture.routing), capture.cache_hits
        n_layout = len(capture.layout)
        reset_launch_counts()
        t0 = time.time()
        counts = perform_inference_and_write_output(
            store, coverage, names, lens, opts, args, {}, 0.0
        )
        torch.cuda.synchronize(device)
        wall = time.time() - t0
        launched = launch_counts()
        impl_ran, iters, em_s = capture.em[n_em]
        assert impl_ran == impl, (impl_ran, impl)
        # one m-step per iteration and the final one; a batch of replicates
        # runs to its slowest replicate's count, all replicates of it in
        # the same launches (the bench plan is one that v4 batches so)
        m_steps = iters + 1
        batched = 0
        boot_s = boot_iters = None
        if boots:
            n_reps, boot_s, boot_iters = capture.boot[n_boot]
            assert n_reps == boots == len(boot_iters) <= BOOT_BATCH
            batched = max(boot_iters) + 1
        want = dict.fromkeys(KERNELS, 0)
        if impl == "pallas":
            want["sorted_gather"] = m_steps + batched
        elif impl == "v4":
            _, fused_run = capture.layout[n_layout]
            assert fused_run == fused, (fused_run, fused)
            want = v4_launches(m_steps + batched, fused, batched)
        assert launched == want, (impl, launched, want)
        assert np.isfinite(counts).all() and counts.shape == (T,)
        assert np.array_equal(read_quant(str(tmp / tag) + ".quant"), counts)
        res = dict(iterations=iters, em_s=em_s,
                   ms_per_iteration=em_s / (iters + 1) * 1e3,
                   bootstrap_s=boot_s, bootstrap_iterations=boot_iters,
                   launches=launched, wall_s=round(wall, 3))
        if impl == "v4":
            # the bench plan's expand stage takes the shared-memory variant
            # of the route stage, its reduce stage the gather through L2
            variants = variant_launches()
            assert variants == dict(shared=m_steps + batched,
                                    gather=m_steps + batched), variants
            res["route_stage_variant_launches"] = variants
            res["routing_s"] = capture.routing[n_route]
            res["plan_cache_hit"] = capture.cache_hits > hits
        return counts, res

    warn0 = len(capture.warnings)
    total = dict.fromkeys(KERNELS, 0)
    runs = {}
    counts = {}
    for tag, impl, boots in (("v4", "v4", REPLICATES), ("v4_again", "v4", 0),
                             ("pallas", "pallas", REPLICATES),
                             ("segsum", "segsum", 0)):
        counts[tag], runs[tag] = run(tag, impl, boots)
        for k, n in runs[tag]["launches"].items():
            total[k] += n
    assert all(total[k] > 0 for k in KERNELS), total
    assert runs["v4"]["launches"]["route_middle_replicates"] > 0
    assert not capture.warnings[warn0:], capture.warnings[warn0:]
    # the first run built the plan and stored it; the second took it from
    # the plan cache and must still give the same bits
    assert not runs["v4"]["plan_cache_hit"]
    assert runs["v4_again"]["plan_cache_hit"]

    c1 = counts["v4"]
    mass_err = abs(c1.sum() - R) / R
    assert mass_err < 1e-5, f"mass off by {mass_err}"
    assert np.array_equal(c1, counts["v4_again"]), "two v4 runs differ"
    l1 = {tag: float(np.abs(c1 - counts[tag]).sum() / R)
          for tag in ("segsum", "pallas")}
    assert max(l1.values()) < L1_OVER_R_LIMIT, (
        f"v4 vs segsum / pallas L1/R = {l1}")
    import pyarrow.parquet as pq

    reps = pq.read_table(str(tmp / "v4") + ".infreps.pq")
    reps = np.stack([np.asarray(reps[c]) for c in reps.column_names])
    assert reps.shape == (REPLICATES, T) and np.isfinite(reps).all()
    rep_mass = float(np.abs(reps.sum(axis=1) - R).max() / R)
    assert rep_mass < 1e-5, f"replicate mass off by {rep_mass}"

    # replicate 0 of the batched program against a serial run with the same
    # multiplicities (the run's seed and defaults; the plan comes out of the
    # plan cache): the same number of iterations and the same bits. The
    # kernels give every replicate the bits of a single launch, and the
    # glue's row sums add each row in a fixed order whatever the batch
    data, order = em_v4.EmV4Data.build(txp_id, w, boundaries, T,
                                       device=device)
    defaults = Args()
    mult0 = sample_multiplicities(
        np.random.default_rng(0), REPLICATES, R)[0, order]
    t0 = time.time()
    serial, serial_iters = em_v4.run_em_v4(
        data, uniform_init(data, torch.float32), defaults.max_em_iter,
        defaults.convergence_thresh,
        multiplicity=torch.as_tensor(mult0, device=device).float())
    serial = serial.double().cpu().numpy()
    serial_s = time.time() - t0
    batch_iters = runs["v4"]["bootstrap_iterations"]
    assert int(serial_iters) == batch_iters[0], (int(serial_iters), batch_iters)
    serial_l1 = float(np.abs(reps[0] - serial).sum() / R)
    assert np.array_equal(reps[0], serial), (
        f"replicate 0 differs from its serial run (L1/R = {serial_l1})")
    del data

    out = dict(R=R, T=T, A=A, dtype="float32", **runs, launches=total,
               mass_rel_err=float(mass_err), l1_over_R_vs_segsum=l1["segsum"],
               l1_over_R_vs_pallas=l1["pallas"], bit_identical_rerun=True,
               replicate_mass_rel_err=rep_mass,
               replicate0_vs_serial=dict(
                   iterations=int(serial_iters), serial_s=round(serial_s, 3),
                   bit_equal=bool(np.array_equal(reps[0], serial)),
                   l1_over_R=serial_l1,
                   max_abs_diff=float(np.abs(reps[0] - serial).max())))
    emit("em_full_width", **out)
    return out, total, counts


def phase_segsum_replicates(csr, R, T, device,
                            max_iter: Optional[int] = None) -> dict:
    """8 multinomial replicates of the segment-sum EM on the bench CSR (f32,
    the CLI's defaults, seed 0) as one batch through `run_replicates`, as a
    user's `--em-impl segsum --num-bootstraps 8` and process 0 of a
    multi-process run take them, and as 8 single `run_em` calls: seconds and
    m-steps of each. Every replicate of the batch must stop where its single
    run stops, with the same bits, and carry the reads' mass. `max_iter`
    caps every run (a bounded measurement of an earlier `ops/em.py`). The
    line is printed before the checks, so that a run that fails them still
    shows its times."""
    txp_id, w, boundaries, A = csr
    read_id = np.repeat(np.arange(R, dtype=np.int32), np.diff(boundaries))
    defaults = Args()
    max_iter = defaults.max_em_iter if max_iter is None else max_iter
    data = EmData.build(txp_id, w, read_id, R, T, dtype=torch.float32,
                        device=device)
    init = uniform_init(data, torch.float32)
    mult = sample_multiplicities(np.random.default_rng(0), REPLICATES, R)

    def run(i, m):
        return run_em(data, i, max_iter, defaults.convergence_thresh,
                      multiplicity=m)

    torch.cuda.synchronize(device)
    t0 = time.time()
    batch, batch_iters = run_replicates(
        replicate_step(data, max_iter, defaults.convergence_thresh), mult,
        init)
    batch_s = time.time() - t0
    singles, single_iters, single_s = [], [], []
    for b in range(REPLICATES):
        t0 = time.time()
        counts, niter = run(init, torch.as_tensor(mult[b], device=device)
                            .float())
        singles.append(counts.double().cpu().numpy())
        single_iters.append(int(niter))
        single_s.append(round(time.time() - t0, 3))
    del data
    singles = np.stack(singles)
    batch_m_steps = int(batch_iters.max()) + 1
    single_m_steps = sum(n + 1 for n in single_iters)
    equal = [bool(np.array_equal(batch[b], singles[b]))
             for b in range(REPLICATES)]
    mass = float(np.abs(batch.sum(axis=1) - R).max() / R)
    out = dict(
        R=R, T=T, A=A, dtype="float32", replicates=REPLICATES,
        max_iter=max_iter, batch_s=round(batch_s, 3),
        batch_m_steps=batch_m_steps,
        batch_ms_per_m_step=batch_s / batch_m_steps * 1e3,
        batch_iterations=batch_iters.tolist(),
        singles_s=round(sum(single_s), 3), single_s=single_s,
        single_m_steps=single_m_steps,
        single_ms_per_m_step=sum(single_s) / single_m_steps * 1e3,
        single_iterations=single_iters,
        batch_over_singles=batch_s / sum(single_s),
        bit_equal=equal,
        max_abs_diff=float(np.abs(batch - singles).max()),
        replicate_mass_rel_err=mass)
    emit("segsum_replicates", **out)
    assert batch_iters.tolist() == single_iters, (batch_iters, single_iters)
    assert all(equal), f"batched replicates differ from single runs: {equal}"
    assert mass < 1e-5, f"replicate mass off by {mass}"
    return out


@contextlib.contextmanager
def recording_v3_builds():
    """Keep the device state of every `EmV3Data.build` made while the block
    runs, so that its kernels can be held against their plain versions on
    the run's own plans afterwards."""
    built = []
    real = em_v3.EmV3Data.build

    def record(*args, **kwargs):
        out = real(*args, **kwargs)
        built.append(out[0])
        return out

    em_v3.EmV3Data.build = staticmethod(record)
    try:
        yield built
    finally:
        em_v3.EmV3Data.build = staticmethod(real)


def plain_permute(x, stage, replicates=1):
    """The tile permute's plain version, as `static_permute` calls it."""
    return tp.tile_permute_reference(x, stage.r1, stage.r2, stage.src,
                                     stage.row, stage.R_in, stage.n_chunks,
                                     replicates)


@contextlib.contextmanager
def plain_v3_kernels():
    """Run the v3 m-step's sorted gather and tile permutes through their
    plain versions on the card while the block runs."""
    gather, permute = em_v3.gather_rows, static_permute.tile_permute
    em_v3.gather_rows = sg.gather_rows_reference
    static_permute.tile_permute = plain_permute
    try:
        yield
    finally:
        em_v3.gather_rows, static_permute.tile_permute = gather, permute


def v3_kernels_vs_plain(data, device) -> dict:
    """K1 on v3's interleaved plan and K2 on each of the four stages of P1
    and P2, bit for bit against their plain versions, f32, with event and
    device times, the plain version's and one `index_select`'s, and the
    bound at the card's memory rate. Back to back, a launch finds part of
    the last one's tables in the 50 MB L2 cache, so each kernel's device
    time is also taken with the cache flushed before each launch, as the
    m-step's other work leaves it."""
    L = sg.LANES
    gen = torch.Generator(device="cpu").manual_seed(3)
    flush = l2_flush(device)

    def cold(fn):
        def run():
            flush()
            fn()
        return run

    def values(*shape):
        return (torch.rand(*shape, generator=gen) - 0.3).to(device)

    # K1: the table of an m-step ([T + 1]), the plan's rows spread over
    # NPAD / 128
    S, NR = data.g_table_rows, data.g_rows
    tab = values(data.num_txps + 1)
    args = (data.g_base, data.g_code, S)
    err = kernel_equals_plain(tab, *args)
    flat, idx = k1_library(tab, data.g_base, data.g_code)
    bit_equal("index_select of K1's function (v3)", flat.index_select(0, idx),
              sg.gather_rows_cuda(tab, *args).reshape(-1),
              against="the kernel")
    k1 = dict(
        n_rows=NR, table_rows=S, pad_rows=int((data.g_base < 0).sum()),
        max_abs_err=err,
        ms=time_ms(lambda: sg.gather_rows_cuda(tab, *args), device),
        plain_ms=time_ms(lambda: sg.gather_rows_reference(tab, *args),
                         device),
        library_ms=time_ms(lambda: flat.index_select(0, idx), device),
        device_ms=device_ms(lambda: sg.gather_rows_cuda(tab, *args), device),
        device_ms_l2_flushed=device_ms(
            cold(lambda: sg.gather_rows_cuda(tab, *args)), device,
            only="sorted_gather_kernel"),
        library_device_ms=device_ms(lambda: flat.index_select(0, idx),
                                    device),
        **k1_bytes(data.g_base, data.g_code, tab.shape[0], S))
    # K2: stages 1 and 3 of both permutes, at R1 / R3 rows
    k2 = {}
    for name in ("p1", "p2"):
        plan = getattr(data, name)
        for tag, t in (("stage1", plan.stage1), ("stage3", plan.stage3)):
            x = values(t.n_tiles * t.rows, L)
            targs = (x, t.r1, t.r2, t.src, t.lane, t.rows, t.n_tiles)
            err = bit_equal(f"tile_permute v3 {name}.{tag}",
                            tp.tile_permute_cuda(x, t.stage),
                            tp.tile_permute_reference(*targs))
            pidx = flat_index(lambda v: tp.tile_permute_reference(
                v.reshape(-1, L), *targs[1:]), x.numel(), device)
            xf = x.reshape(-1)
            k2[f"{name}.{tag}"] = dict(
                rows=t.rows, n_tiles=t.n_tiles, elements=x.numel(),
                offset_dtype=str(t.stage.off.dtype),
                offset_bytes=nbytes(t.stage.off), max_abs_err=err,
                ms=time_ms(lambda: tp.tile_permute_cuda(x, t.stage), device),
                plain_ms=time_ms(lambda: tp.tile_permute_reference(*targs),
                                 device, 5, 5),
                library_ms=time_ms(lambda: xf.index_select(0, pidx), device),
                device_ms=device_ms(lambda: tp.tile_permute_cuda(x, t.stage),
                                    device),
                device_ms_l2_flushed=device_ms(
                    cold(lambda: tp.tile_permute_cuda(x, t.stage)), device,
                    only="tile_permute_kernel"),
                library_device_ms=device_ms(
                    lambda: xf.index_select(0, pidx), device),
                **bound(nbytes(x, x, t.r1, t.r2, t.src, t.lane), 0,
                        moved=nbytes(x, x, t.stage.off)))
            del x, xf, pidx
    return dict(sorted_gather=k1, tile_permute=k2)


def phase_em_v3(csr, R, T, device, tmp: Path, capture, counts_em):
    """`--em-impl v3` on the bench CSR at full width through
    `perform_inference_and_write_output`, f32, with 8 bootstrap replicates
    (one after another); K1 and K2 against their plain versions on the
    run's own plans; the SQUAREM runner (`make_runner(accel="squarem")`)
    on the same device state; mass, and L1/R against the `segsum` and `v4`
    runs of `em_full_width`. Returns (the phase's line, launches per
    kernel)."""
    store, names, lens, coverage = bench_store(csr, R, T)

    def run(tag, boots):
        args = Args(output=tmp / tag, em_impl="v3", em_dtype="float32",
                    num_bootstraps=boots, seed=0)
        n_em, n_boot = len(capture.em), len(capture.boot)
        n_route, n_layout = len(capture.v3_routing), len(capture.v3_layout)
        warn0 = len(capture.warnings)
        with recording_v3_builds() as built:
            reset_launch_counts()
            t0 = time.time()
            counts = perform_inference_and_write_output(
                store, coverage, names, lens, resolve_filters(args), args,
                {}, 0.0)
            torch.cuda.synchronize(device)
            wall = time.time() - t0
            launched = launch_counts()
        assert not capture.warnings[warn0:], capture.warnings[warn0:]
        impl_ran, iters, em_s = capture.em[n_em]
        assert impl_ran == "v3", impl_ran
        # an m-step per iteration and the final one, for the run and for
        # each replicate (no batch arm: one after another)
        m_steps = iters + 1
        boot_s = boot_iters = None
        if boots:
            n_reps, boot_s, boot_iters = capture.boot[n_boot]
            assert n_reps == boots == len(boot_iters)
            m_steps += sum(n + 1 for n in boot_iters)
        want = dict.fromkeys(KERNELS, 0)
        want.update(sorted_gather=m_steps, tile_permute=4 * m_steps)
        assert launched == want, (tag, launched, want)
        assert np.isfinite(counts).all() and counts.shape == (T,)
        assert np.array_equal(read_quant(str(tmp / tag) + ".quant"), counts)
        (data,) = built
        npad, n_src, q1, q2, r1a, r1b, r3a, r3b = capture.v3_layout[n_layout]
        res = dict(iterations=iters, em_s=em_s,
                   ms_per_iteration=em_s / (iters + 1) * 1e3,
                   routing_s=capture.v3_routing[n_route],
                   bootstrap_s=boot_s, bootstrap_iterations=boot_iters,
                   launches=launched, wall_s=round(wall, 3),
                   layout=dict(NPAD=npad, n_src=n_src, Q=[q1, q2],
                               R1=[r1a, r1b], R3=[r3a, r3b]))
        return counts, res, data

    runs = {}
    c, runs["v3"], data = run("v3", REPLICATES)
    total = dict(runs["v3"]["launches"])
    offsets = {f"{p}.{s}": nbytes(getattr(getattr(data, p), s).stage.off)
               for p in ("p1", "p2") for s in ("stage1", "stage3")}
    kernels = v3_kernels_vs_plain(data, device)

    # SQUAREM on the same device state: a cycle is 3 m-steps, and the
    # final step. Its clamp at zero and the zeroing before the final step
    # make its stopping point turn on the last bits of f32 sums (on this
    # CSR it drops about a quarter of the reads' mass, the JAX package's
    # SQUAREM too: ROADMAP section C), so v3 and segment sums stop after
    # different numbers of m-steps. The run through K1 and K2 must equal,
    # bit for bit, the same run through their plain versions on the card,
    # and come within L1/R 2e-3 of the segment-sum SQUAREM
    defaults = Args()
    run_sq = em_v3.make_runner(data, accel="squarem")

    def squarem():
        t0 = time.time()
        out, n = run_sq(uniform_init(data, torch.float32),
                        defaults.max_em_iter, defaults.convergence_thresh)
        out = out.double().cpu().numpy()
        return out, int(n), time.time() - t0

    reset_launch_counts()
    sq, sq_iters, sq_s = squarem()
    launched = launch_counts()
    want = dict.fromkeys(KERNELS, 0)
    want.update(sorted_gather=sq_iters + 1, tile_permute=4 * (sq_iters + 1))
    assert launched == want, ("squarem", launched, want)
    for k, n in launched.items():
        total[k] += n
    with plain_v3_kernels():
        sq_plain, sq_plain_iters, sq_plain_s = squarem()
    assert launch_counts() == launched, "the plain run launched a kernel"
    assert np.isfinite(sq).all() and sq_iters == sq_plain_iters, (
        sq_iters, sq_plain_iters)
    assert np.array_equal(sq, sq_plain), (
        "v3 SQUAREM through K1/K2 differs from its plain versions: L1/R "
        f"{float(np.abs(sq - sq_plain).sum() / R)}")
    del data
    txp_id, w, boundaries, _ = csr
    seg = EmData.build(txp_id, w, np.repeat(np.arange(R), np.diff(boundaries)),
                       R, T, dtype=torch.float32, device=device)
    seg_sq, seg_iters = run_em_squarem(seg, uniform_init(seg, torch.float32),
                                       defaults.max_em_iter,
                                       defaults.convergence_thresh)
    seg_sq = seg_sq.double().cpu().numpy()
    del seg
    sq_l1 = float(np.abs(sq - seg_sq).sum() / R)
    assert sq_l1 < L1_OVER_R_LIMIT, f"v3 vs segsum SQUAREM L1/R = {sq_l1}"
    runs["squarem"] = dict(
        iterations=sq_iters, em_s=round(sq_s, 3),
        ms_per_iteration=sq_s / (sq_iters + 1) * 1e3, launches=launched,
        plain_versions=dict(iterations=sq_plain_iters,
                            em_s=round(sq_plain_s, 3), bit_equal=True),
        mass_rel_err=float(abs(sq.sum() - R) / R),
        segsum_squarem=dict(
            iterations=int(seg_iters),
            mass_rel_err=float(abs(seg_sq.sum() - R) / R),
            l1_over_R=sq_l1),
        l1_over_R_vs_plain_em=float(np.abs(sq - c).sum() / R))

    mass_err = abs(c.sum() - R) / R
    assert mass_err < 1e-5, f"v3 mass off by {mass_err}"
    l1 = {tag: float(np.abs(c - counts_em[tag]).sum() / R)
          for tag in ("segsum", "v4")}
    assert max(l1.values()) < L1_OVER_R_LIMIT, f"v3 L1/R = {l1}"
    import pyarrow.parquet as pq

    reps = pq.read_table(str(tmp / "v3") + ".infreps.pq")
    reps = np.stack([np.asarray(reps[col]) for col in reps.column_names])
    assert reps.shape == (REPLICATES, T) and np.isfinite(reps).all()
    rep_mass = float(np.abs(reps.sum(axis=1) - R).max() / R)
    assert rep_mass < 1e-5, f"v3 replicate mass off by {rep_mass}"
    out = dict(R=R, T=T, A=csr[3], dtype="float32", **runs,
               k2_offset_bytes=offsets,
               k2_offset_bytes_total=sum(offsets.values()),
               mass_rel_err=float(mass_err), l1_over_R=l1,
               replicate_mass_rel_err=rep_mass, kernels=kernels,
               launches=total)
    emit("em_v3", **out)
    return out, total


def e2e_halves(tmp: Path) -> list:
    """The cli_e2e BAM's two halves of the reads, for two processes."""
    return [tmp / f"e2e_half.{i}.bam" for i in range(2)]


def run_cli(bam: Path, out: Path, extra, device, capture):
    """One run of the CLI; returns (argv, counts, reads kept, meta, (impl,
    iterations, EM seconds), launches per kernel, wall seconds)."""
    argv = ["--alignments", str(bam), "-o", str(out), "--model-coverage",
            "--write-assignment-probs", *extra]
    n_em, warn0 = len(capture.em), len(capture.warnings)
    reset_launch_counts()
    t0 = time.time()
    rc = cli_main(argv)
    torch.cuda.synchronize(device)
    wall = time.time() - t0
    launched = launch_counts()
    assert rc == 0
    assert not capture.warnings[warn0:], capture.warnings[warn0:]
    for ext in (".quant", ".ambig_info.tsv", ".meta_info.json", ".prob"):
        assert Path(str(out) + ext).stat().st_size > 0, ext
    counts = read_quant(str(out) + ".quant")
    assert np.isfinite(counts).all()
    meta = json.loads(Path(str(out) + ".meta_info.json").read_text())
    kept = int(meta["discard_table"]["valid_best_aln"])
    mass_err = abs(counts.sum() - kept) / kept
    assert mass_err < 1e-5, f"mass {counts.sum()} vs {kept} reads kept"
    return argv, counts, kept, meta, capture.em[n_em], launched, wall


@contextlib.contextmanager
def environment(**values):
    """Set environment variables for the block (None: unset), then put
    back what was there."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def file_digest(path) -> str:
    h = hashlib.blake2b(digest_size=20)
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


# the CLI runs of the host work hidden behind the pack: (a) without it and
# with a fresh plan cache, (b) with it and another fresh cache, (c) with it
# again on (b)'s cache, whose BAM pointer gives a prefetch hit
A8_RUNS = (("no_prebuild", "0", "plans_a"), ("prebuild", None, "plans_b"),
           ("prefetch", None, "plans_b"))
A8_OUTPUTS = (".quant", ".ambig_info.tsv", ".prob")


def phase_cli_e2e(R, T, device, tmp: Path, capture):
    """Returns (the phase's line, launches per kernel in the phase)."""
    bam = tmp / "e2e.bam"
    t0 = time.time()
    # the `sharded` phase's two halves of the reads, written in the pass
    n_alns = build_e2e_bam(bam, R, T, parts=e2e_halves(tmp))
    gen_s = time.time() - t0
    # the defaults: cuda, and `auto`, which takes v4 at this size
    runs, outputs, launched = {}, {}, dict.fromkeys(KERNELS, 0)
    for tag, prebuild, cache in A8_RUNS:
        n_auto, n_route, n_layout = (len(capture.auto), len(capture.routing),
                                     len(capture.layout))
        n_pb, hits = len(capture.prebuild), capture.prefetch_hits
        with environment(OARFISH_PREBUILD=prebuild,
                         OARFISH_PLAN_CACHE_DIR=str(tmp / cache)):
            argv, counts, kept, meta, (impl, iters, em_s), run_launched, wall = (
                run_cli(bam, tmp / f"cli_{tag}", [], device, capture))
        assert counts.shape == (T,)
        assert capture.auto[n_auto:] == ["v4"], capture.auto[n_auto:]
        assert impl == "v4", f"auto chose {impl}, expected v4"
        assert len(capture.layout) == n_layout + 1
        n_big, fused = capture.layout[-1]
        assert run_launched == v4_launches(iters + 1, fused), (
            run_launched, iters, n_big, fused)
        for k, n in run_launched.items():
            launched[k] += n
        outputs[tag] = {ext: file_digest(str(tmp / f"cli_{tag}") + ext)
                        for ext in A8_OUTPUTS}
        runs[tag] = dict(
            wall_s=round(wall, 2),
            pack_s=round(float(meta["alignment_time"]["seconds"]), 2),
            routing_s=capture.routing[n_route],
            prebuild_finish_s=(capture.prebuild[n_pb]
                               if len(capture.prebuild) > n_pb else None),
            prefetch_hit=capture.prefetch_hits > hits,
            iterations=iters, em_s=em_s, launches=run_launched,
            reads_kept=kept,
            mass_rel_err=float(abs(counts.sum() - kept) / kept))
        if tag == "no_prebuild":
            first = dict(argv=argv, kept=kept, iters=iters, em_s=em_s,
                         counts=counts)
    # the hidden host work changes no byte, and the third run took the
    # plan that the second stored, through the BAM's pointer file
    for tag in ("prebuild", "prefetch"):
        assert outputs[tag] == outputs["no_prebuild"], (
            f"{tag} run's outputs differ from the run without prebuild")
    assert not runs["no_prebuild"]["prefetch_hit"]
    assert not runs["prebuild"]["prefetch_hit"]
    assert runs["prefetch"]["prefetch_hit"], "no prefetch hit in run (c)"
    res = dict(
        R=R, T=T, records=n_alns,
        native_decoder=native.available(),
        bam_mb=round(bam.stat().st_size / 2**20, 1),
        bam_build_s=round(gen_s, 2), **runs["no_prebuild"],
        em_impl="v4", auto=True,
        a8_runs=runs, a8_outputs_byte_equal=True,
        a8_prefetch_skipped_route_build=runs["prefetch"]["prefetch_hit"],
    )
    res["launches"] = launched
    res["mass_rel_err"] = float(
        abs(first["counts"].sum() - first["kept"]) / first["kept"])
    phase_covmodel_device_vs_host(bam, first["argv"], first["kept"], device)
    # the BAM and its halves stay for the `sharded` phase, which removes
    # the halves, and the BAM for mode_bench, which removes it

    # an earlier path at a smaller size: `--em-impl pallas`, and the
    # sorted-gather kernel against its plain version on this BAM's own
    # gather plan (another row count and base / hi pattern than the bench
    # CSR's): the plan is a function of the kept alignments' transcript
    # ids alone
    small = tmp / "small.bam"
    build_e2e_bam(small, SMALL_READS, T, seed=1)
    argv, counts2, kept2, _, (impl2, iters2, em_s2), launched2, wall2 = (
        run_cli(small, tmp / "cli_pallas", ["--em-impl", "pallas"], device,
                capture))
    assert impl2 == "pallas"
    want = dict.fromkeys(KERNELS, 0)
    want["sorted_gather"] = iters2 + 1
    assert launched2 == want, (launched2, want)
    t0 = time.time()
    args = to_args(build_parser().parse_args(argv))
    _, store, _, _ = pack_bam_fast(
        small, resolve_filters(args), bin_width=args.bin_width,
        threads=max(args.threads, 1),
    )
    assert store.num_reads == kept2
    plan = sg.SortedGatherPlan.build(np.sort(store.txp_id), T + 1,
                                     device=device)
    rng = np.random.default_rng(2)
    tab = torch.as_tensor(rng.random(T + 1), device=device).float()
    k1_args = (plan.base, plan.code, plan.table_rows)
    k1_err = kernel_equals_plain(tab, *k1_args)
    k1_ms = time_ms(lambda: sg.gather_rows_cuda(tab, *k1_args), device)
    res["pallas_run"] = dict(
        R=SMALL_READS, reads_kept=kept2, wall_s=round(wall2, 2),
        iterations=iters2, em_s=em_s2, launches=launched2,
        k1_plan=dict(n_rows=plan.n_rows, table_rows=plan.table_rows,
                     bit_equal=True, max_abs_err=k1_err, ms=k1_ms,
                     check_s=round(time.time() - t0, 2)))
    emit("cli_e2e", **res)
    return res, {k: launched[k] + launched2[k] for k in KERNELS}


# the hand-written kernels by their `__global__` names, as a trace shows
# them, under the launch counter that counts them (a replicate arm's
# launches are also those of its kernel)
TRACE_NAMES = {
    "sorted_gather": ("sorted_gather_kernel",),
    "tile_permute": ("tile_permute_kernel",),
    "route_stage": ("route_stage_shared_kernel", "route_stage_gather_kernel"),
    "route_middle": ("route_middle_kernel",),
    "row_sums": ("row_sums_kernel",),
}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def read_trace(directory: Path) -> tuple:
    """The one trace a CLI run left in `directory`: (path, its events)."""
    found = sorted(directory.glob("*.pt.trace.json.gz"))
    assert len(found) == 1, found
    with gzip.open(found[0], "rt") as fh:
        return found[0], json.load(fh)["traceEvents"]


def launch_counter(event) -> Optional[str]:
    """The launch counter of a trace event's hand-written kernel, or None
    where the event is no such kernel."""
    if event.get("cat") == "kernel":
        for key, globals_ in TRACE_NAMES.items():
            if any(g in event["name"] for g in globals_):
                return key
    return None


def trace_kernel_counts(events) -> tuple:
    """Each launch counter's events in a trace, and the names under which
    the trace shows the hand-written kernels."""
    counts, names = dict.fromkeys(TRACE_NAMES, 0), set()
    for e in events:
        key = launch_counter(e)
        if key is not None:
            counts[key] += 1
            names.add(e["name"])
    return counts, sorted(names)


def union_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of `(start, end)` intervals within `[lo, hi]`."""
    total, reach = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, reach), min(b, hi)
        if b > a:
            total += b - a
            reach = b
    return total


def busy_shares(events) -> dict:
    """The card's busy share of a trace: the union of its kernels' intervals
    (and of every device activity: kernels, copies, fills) over the
    profiled span (the profiler's own `Trace` event), and the kernels' over
    the EM's span, from the first hand-written kernel's start to the last
    one's end."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    span = [e for e in xs if e.get("cat") == "Trace"]
    lo, hi = ((span[0]["ts"], span[0]["ts"] + span[0]["dur"]) if span else
              (min(e["ts"] for e in xs), max(e["ts"] + e["dur"] for e in xs)))
    kernels = [(e["ts"], e["ts"] + e["dur"]) for e in xs
               if e.get("cat") == "kernel"]
    device = [(e["ts"], e["ts"] + e["dur"]) for e in xs
              if e.get("cat") in DEVICE_CATS]
    ours = [(e["ts"], e["ts"] + e["dur"]) for e in xs
            if launch_counter(e) is not None]
    out = dict(span_s=(hi - lo) / 1e6, kernels=len(kernels),
               kernel_busy_share=union_us(kernels, lo, hi) / (hi - lo),
               device_busy_share=union_us(device, lo, hi) / (hi - lo))
    if ours:
        a, b = min(s for s, _ in ours), max(e for _, e in ours)
        out.update(em_span_s=(b - a) / 1e6,
                   em_kernel_busy_share=union_us(kernels, a, b) / (b - a))
    return out


def phase_cli_profile(device, tmp: Path, capture, cli: dict) -> tuple:
    """The CLI with `--profile-dir` on cli_e2e's two BAMs: the 1.7 GB BAM
    at the defaults (auto -> v4) on the plan cache of cli_e2e's run (c),
    and the smaller one with `--em-impl pallas`. Each run's outputs must
    be the bytes of its unprofiled twin from cli_e2e, and each
    hand-written kernel's events in its trace as many as the wrapper's
    launch counter counted; on a mismatch the run is made once more and
    both attempts are reported. Returns (the phase's line, launches per
    kernel in the phase)."""
    t_phase = time.time()
    runs, launched, failed = {}, dict.fromkeys(KERNELS, 0), []
    for tag, bam, extra, twin, twin_wall, env in (
            ("v4", tmp / "e2e.bam", [], "cli_prefetch",
             cli["a8_runs"]["prefetch"]["wall_s"],
             dict(OARFISH_PLAN_CACHE_DIR=str(tmp / "plans_b"))),
            ("pallas", tmp / "small.bam", ["--em-impl", "pallas"],
             "cli_pallas", cli["pallas_run"]["wall_s"], {})):
        want_files = {ext: file_digest(str(tmp / twin) + ext)
                      for ext in A8_OUTPUTS}
        attempts = []
        for attempt in range(2):
            out, trace_dir = (tmp / f"cli_profile_{tag}",
                              tmp / f"trace_{tag}_{attempt}")
            hits = capture.prefetch_hits
            with environment(**env):
                _, _, kept, _, (impl, iters, em_s), run_launched, wall = (
                    run_cli(bam, out, [*extra, "--profile-dir",
                                       str(trace_dir)], device, capture))
            assert impl == tag, (impl, tag)
            files = {ext: file_digest(str(out) + ext) for ext in A8_OUTPUTS}
            assert files == want_files, (
                f"profiled {tag} run's outputs differ from {twin}'s")
            for k, n in run_launched.items():
                launched[k] += n
            t0 = time.time()
            path, events = read_trace(trace_dir)
            counts, names = trace_kernel_counts(events)
            want = {k: run_launched[k] for k in TRACE_NAMES}
            attempts.append(dict(
                wall_s=round(wall, 2), twin_wall_s=twin_wall,
                iterations=iters, em_s=em_s, reads_kept=kept,
                prefetch_hit=capture.prefetch_hits > hits,
                trace_mb=round(path.stat().st_size / 2**20, 2),
                trace_events=len(events), parse_s=round(time.time() - t0, 2),
                launches=want, trace_counts=counts,
                counts_equal=counts == want, kernel_names=names,
                **busy_shares(events)))
            del events
            shutil.rmtree(trace_dir)
            if counts == want:
                break
        for ext in A8_OUTPUTS:
            Path(str(out) + ext).unlink()
        runs[tag] = dict(attempts=attempts, outputs_byte_equal=True)
        if not attempts[-1]["counts_equal"]:
            failed.append(tag)
    emit("cli_profile", **runs, launches=launched,
         phase_s=round(time.time() - t_phase, 1))
    if failed:
        raise AssertionError(
            f"the trace's kernel counts differ from the launch counters "
            f"twice: {failed}")
    return runs, launched


@contextlib.contextmanager
def plain_v4_kernels():
    """Run the v4 m-step's tile permutes, route stages, fused middle and row
    sums through their plain versions on the card while the block runs (the
    row sums' plain version adds on the host)."""
    saved = (static_permute.route_stage, static_permute.tile_permute,
             em_v4.route_middle, em_v4.row_sums)
    static_permute.route_stage = (
        lambda x, stage, mul=None: stage.reference(x, mul=mul))
    static_permute.tile_permute = plain_permute
    em_v4.route_middle = rm.route_middle_reference
    em_v4.row_sums = lambda x, what: rsm.plan_reference(x, rsm._plan(what))
    try:
        yield
    finally:
        (static_permute.route_stage, static_permute.tile_permute,
         em_v4.route_middle, em_v4.row_sums) = saved


@contextlib.contextmanager
def recording_sharded_builds():
    """Keep every sharded v4 state that `quant/bulk.py` builds while the
    block runs."""
    built = []
    real = bulk.build_sharded_v4

    def record(*args, **kwargs):
        out = real(*args, **kwargs)
        built.append(out[0])
        return out

    bulk.build_sharded_v4 = record
    try:
        yield built
    finally:
        bulk.build_sharded_v4 = real


def sharded_m_steps_equal_plain(sh, device) -> dict:
    """One m-step of each shard, single and for a batch of 8 replicates,
    through the kernels and through their plain versions: the same bits,
    f32. Launched after the main path's counts were read."""
    rng = np.random.default_rng(5)
    T = sh.num_txps
    prev = torch.zeros(sh.t_space, device=device)
    prev[:T] = torch.as_tensor(rng.uniform(0.5, 2.0, T), device=device)
    prev_b = prev.expand(REPLICATES, -1).contiguous()
    mult = sh.shard_multiplicity_batch(sample_multiplicities(
        rng, REPLICATES, sh.num_reads))
    t0 = time.time()
    shards = []
    for d, data in enumerate(sh.datas):
        m_b = torch.as_tensor(mult[d], device=data.device)
        single = em_v4.make_m_step(data, None)
        batch = em_v4.make_m_step(data, m_b)
        got = (single(prev), batch(prev_b))
        with plain_v4_kernels():
            want = (em_v4.make_m_step(data, None)(prev),
                    em_v4.make_m_step(data, m_b)(prev_b))
        for tag, g, w in zip(("single", "batch"), got, want):
            bit_equal(f"shard {d} m-step ({tag})", g, w)
        shards.append(dict(shard=d, bit_equal=True,
                           batch_eligible=em_v4._batch_eligible(data)))
    return dict(shards=shards, replicates=REPLICATES,
                check_s=round(time.time() - t0, 2))


def sharded_launches(D: int, m_steps: int, fused: bool, batched: int,
                     eligible: bool) -> dict:
    """Launches of D shards: each runs `m_steps` single m-steps and
    `batched` m-steps of one batch of replicates (one program where its
    layout allows it, else the replicates one after another)."""
    one = v4_launches(m_steps, fused)
    if batched:
        extra = (v4_launches(batched, fused, batched) if eligible
                 else v4_launches(REPLICATES * batched, fused))
        one = {k: one[k] + extra[k] for k in one}
    return {k: D * n for k, n in one.items()}


# the CLI runs of several processes: (b) every process packs the whole BAM
# and process 0 runs the 2 replicates alone, as one batch of segment sums,
# (c) process i packs `e2e_half.{i}.bam` and takes its part of every
# replicate's m-steps; the one-process run of the whole draws the same 2
PROCESS_RUNS = ("whole", "halves")
PROCESS_FLAGS = ["--model-coverage", "--write-assignment-probs",
                 "--em-impl", "segsum", "--num-bootstraps", "2"]
# process 0's replicates: (b) alone after the EM, with the inputs' build;
# (c) shared by both processes
MULTI_BOOT = re.compile(r"(\d+) bootstrap replicates (?:on process 0 |"
                        r"\(sharded ingest\) )in ([0-9.]+)s"
                        r"(?: \(inputs ([0-9.]+)s\))?")
MULTI_EM = re.compile(r"multi-process EM \((\d+) processes, (\d+) shards"
                      r"[^)]*\) converged after (\d+) iterations in "
                      r"([0-9.]+)s; (\d+) all-reduces, ([0-9.]+)s in them")


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_processes(bam: str, out_of, n: int, logs: Path, extra=(),
                  timeout: int = 300) -> list:
    """`n` processes of the port's CLI on this card, one gloo group at a
    free local port, each logging into a file under `logs`; returns per
    process (wall seconds, log). Every process is waited for, and killed
    if it outlives `timeout`."""
    root = Path(__file__).resolve().parent
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(root))
    procs, files = [], []
    t0 = time.time()
    try:
        for i in range(n):
            files.append(open(logs / f"process{i}.log", "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "oarfish_tpu_torch", "--alignments",
                 bam, "-o", str(out_of(i)), *PROCESS_FLAGS, *extra,
                 "--coordinator",
                 f"localhost:{port}", "--num-processes", str(n),
                 "--process-id", str(i)],
                env=env, stdout=subprocess.DEVNULL, stderr=files[-1],
                cwd=root))
        out = []
        for i, (p, fh) in enumerate(zip(procs, files)):
            p.wait(timeout=max(timeout - (time.time() - t0), 1))
            fh.seek(0)
            err = fh.read()
            out.append((round(time.time() - t0, 2), err))
            if p.returncode != 0:
                raise RuntimeError(f"process {i} of {n} failed "
                                   f"(rc {p.returncode}):\n{err[-3000:]}")
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fh in files:
            fh.close()


def same_meta(a: Path, b: Path, but=()) -> bool:
    """`meta_info.json` equal but for paths, timings and the keys `but`."""
    def load(path):
        meta = json.loads(Path(path).read_text())
        for k in ("alignment_time", "output", "alignments", *but):
            meta.pop(k, None)
        return meta

    return load(a) == load(b)


def prob_reads(path) -> list:
    """The read names of a `.prob` file."""
    with open(path) as fh:
        n_txps, n_reads = (int(x) for x in fh.readline().split("\t"))
        for _ in range(n_txps):
            fh.readline()
        reads = [ln.split("\t", 1)[0] for ln in fh]
    assert len(reads) == n_reads, (path, len(reads), n_reads)
    return reads


def phase_sharded(csr, R, T, device, tmp: Path, capture, counts_v4,
                  bam: Path):
    """(a) The bench CSR through `perform_inference_and_write_output` with
    `--num-shards 2` (`v4`, 8 replicates in one batch) and 4 (the point
    EM), all shards on this card; (b) two processes of the CLI on `bam`
    against one, (c) two processes each packing half of its reads.
    Returns (the phase's line, launches per kernel of (a)). `bam` and its
    halves (`e2e_halves`) are cli_e2e's; the halves are removed here, `bam`
    by mode_bench."""
    store, names, lens, coverage = bench_store(csr, R, T)
    runs, launched = {}, dict.fromkeys(KERNELS, 0)
    with recording_sharded_builds() as built:
        for D, boots in ((2, REPLICATES), (4, 0)):
            tag = f"v4_{D}_shards"
            args = Args(output=tmp / tag, em_impl="v4", em_dtype="float32",
                        num_bootstraps=boots, num_shards=D, seed=0)
            n_sh, n_boot = len(capture.sharded), len(capture.boot)
            torch.cuda.reset_peak_memory_stats(device)
            reset_launch_counts()
            t0 = time.time()
            counts = perform_inference_and_write_output(
                store, coverage, names, lens, resolve_filters(args), args,
                {}, 0.0)
            torch.cuda.synchronize(device)
            wall = time.time() - t0
            run_launched = launch_counts()
            (_, (build_s, shards)), (_, (iters, em_s)) = (
                capture.sharded[n_sh:n_sh + 2])
            iters, em_s = int(iters), float(em_s)
            sh = built[-1]
            assert int(shards) == D == sh.num_shards
            assert all(d.device == device for d in sh.datas)
            fused = sh.datas[0].seg_id is not None
            eligible = em_v4._batch_eligible(sh.datas[0])
            batched = boot_s = boot_iters = None
            if boots:
                n_reps, boot_s, boot_iters = capture.boot[n_boot]
                assert n_reps == boots == len(boot_iters) <= BOOT_BATCH
                batched = max(boot_iters) + 1
            want = sharded_launches(D, iters + 1, fused, batched or 0,
                                    eligible)
            assert run_launched == want, (tag, run_launched, want)
            for k, n in run_launched.items():
                launched[k] += n
            assert np.isfinite(counts).all() and counts.shape == (T,)
            mass = float(abs(counts.sum() - R) / R)
            assert mass < 1e-5, f"{tag}: mass off by {mass}"
            l1 = float(np.abs(counts - counts_v4).sum() / R)
            assert l1 < L1_OVER_R_LIMIT, f"{tag} vs unsharded v4 L1/R {l1}"
            runs[tag] = dict(
                shards=D, build_s=float(build_s), iterations=iters,
                em_s=em_s, ms_per_iteration=em_s / (iters + 1) * 1e3,
                bootstrap_s=boot_s, bootstrap_iterations=boot_iters,
                wall_s=round(wall, 3),
                peak_device_memory_mb=round(
                    torch.cuda.max_memory_allocated(device) / 2**20, 1),
                geometry=list(sh.geometry[:2]) + list(sh.geometry[2]),
                t_space=sh.t_space, fused_middle=fused,
                batch_one_program=eligible, launches=run_launched,
                mass_rel_err=mass, l1_over_R_vs_unsharded_v4=l1)
            if boots:
                import pyarrow.parquet as pq

                reps = pq.read_table(str(tmp / tag) + ".infreps.pq")
                reps = np.stack([np.asarray(reps[c])
                                 for c in reps.column_names])
                assert reps.shape == (boots, T) and np.isfinite(reps).all()
                rep_mass = float(np.abs(reps.sum(axis=1) - R).max() / R)
                assert rep_mass < 1e-5, f"replicate mass off by {rep_mass}"
                runs[tag]["replicate_mass_rel_err"] = rep_mass
        # one m-step of every shard of the two-shard build, single and
        # batched, through the kernels and their plain versions
        m_steps = sharded_m_steps_equal_plain(built[0], device)
    del built, store
    torch.cuda.empty_cache()

    # (b) and (c): two processes of the CLI against one, on the card
    t0 = time.time()
    single = tmp / "mp_single"
    n_boot = len(capture.boot)
    argv, counts1, kept, meta1, _, _, wall1 = run_cli(
        bam, single, PROCESS_FLAGS[2:], device, capture)
    single_s = time.time() - t0
    _, single_boot_s, _ = capture.boot[n_boot]
    import pyarrow.parquet as pq

    def replicates(prefix):
        reps = pq.read_table(str(prefix) + ".infreps.pq")
        return np.stack([np.asarray(reps[c]) for c in reps.column_names])

    reps1 = replicates(single)
    halves = e2e_halves(tmp)
    procs = {}
    for tag in PROCESS_RUNS:
        src = str(bam) if tag == "whole" else str(tmp / "e2e_half.{proc}.bam")
        out = run_processes(src, lambda i, tag=tag: tmp / f"mp_{tag}{i}", 2,
                            tmp)
        m = MULTI_EM.search(out[0][1])
        assert m, out[0][1][-2000:]
        n_proc, n_shards, iters, em_s, n_ar, ar_s = m.groups()
        assert (int(n_proc), int(n_shards)) == (2, 2)
        counts = read_quant(tmp / f"mp_{tag}0.quant")
        l1 = float(np.abs(counts - counts1).sum() / R)
        assert l1 < L1_OVER_R_LIMIT, f"{tag}: L1/R {l1} against one process"
        mass = float(abs(counts.sum() - kept) / kept)
        assert mass < 1e-5, f"{tag}: mass off by {mass}"
        for ext in (".ambig_info.tsv",):
            assert (Path(str(tmp / f"mp_{tag}0") + ext).read_bytes()
                    == Path(str(single) + ext).read_bytes()), (tag, ext)
        assert same_meta(tmp / f"mp_{tag}0.meta_info.json",
                         str(single) + ".meta_info.json"), tag
        # process 1 writes nothing but, with its own reads, its part of
        # the assignment probabilities
        own = sorted(p.name for p in tmp.glob(f"mp_{tag}1*"))
        want_own = [] if tag == "whole" else [f"mp_{tag}1.part1.prob"]
        assert own == want_own, (tag, own)
        res = dict(walls_s=[w for w, _ in out], iterations=int(iters),
                   em_s=float(em_s), all_reduces=int(n_ar),
                   all_reduce_s=float(ar_s),
                   all_reduce_share_of_em=float(ar_s) / float(em_s),
                   l1_over_R_vs_one_process=l1, mass_rel_err=mass)
        boot = MULTI_BOOT.search(out[0][1])
        assert boot and boot.group(1) == "2", out[0][1][-2000:]
        res["bootstrap_s"] = float(boot.group(2))
        if boot.group(3) is not None:
            res["bootstrap_inputs_s"] = float(boot.group(3))
        reps = replicates(tmp / f"mp_{tag}0")
        assert reps.shape == (2, T) and np.isfinite(reps).all()
        rep_mass = float(np.abs(reps.sum(axis=1) - kept).max() / kept)
        assert rep_mass < 1e-5, f"replicate mass off by {rep_mass}"
        res["replicate_mass_rel_err"] = rep_mass
        if tag == "whole":
            # process 0 ran the one-process run's batch on the same store
            assert np.array_equal(reps, reps1), "replicates differ"
            res["replicates_equal_one_process"] = True
        else:
            # one multinomial over both processes' reads
            parts = [prob_reads(tmp / f"mp_halves{i}.part{i}.prob")
                     for i in range(2)]
            whole = prob_reads(str(single) + ".prob")
            assert sorted(parts[0] + parts[1]) == sorted(whole)
            res["part_reads"] = [len(p) for p in parts]
        procs[tag] = res
        for f in tmp.glob(f"mp_{tag}*"):
            f.unlink()
    for f in halves:
        f.unlink()
    out = dict(R=R, T=T, dtype="float32", **runs, m_steps_vs_plain=m_steps,
               launches=launched, one_process=dict(
                   wall_s=round(wall1, 2), run_s=round(single_s, 2),
                   bootstrap_s=single_boot_s, reads_kept=kept),
               **{
                   f"processes_{k}": v for k, v in procs.items()})
    emit("sharded", **out)
    return out, launched


def bench_main(argv, **env) -> tuple:
    """`python -m oarfish_tpu_torch.bench ARGV` in this process, with the
    environment `env`: (its one JSON line, what it ran, launches per
    kernel), the counts set to 0 just before it."""
    buf = io.StringIO()
    reset_launch_counts()
    with environment(**env), contextlib.redirect_stdout(buf):
        res = bench_mod.main(argv)
    launched = launch_counts()
    lines = buf.getvalue().splitlines()
    assert len(lines) == 1, lines
    line = json.loads(lines[0])
    assert line == res.line, (line, res.line)
    return line, res, launched


def phase_bench(R, T, device, tmp: Path, em_full) -> tuple:
    """The port's benchmark through its entry point: `python -m
    oarfish_tpu_torch.bench` with the default `v4` and with
    `OARFISH_BENCH_IMPL=pallas` at the bench shape, then `--e2e --quick
    --reps 1`. Exact launches for each (a loop of n iterations is n + 1
    m-steps), the mass of its counts, and each bench's `ms_per_iter`
    between its m-step's own time between CUDA events (`queued_ms`: the
    card's time, which a loop timed without a synchronize could read
    below; back to back from the host a `pallas` m-step takes the host's
    pace, which the loop can match) and 5 times em_full_width's ms per
    iteration of the same formulation. Returns (the phase's line,
    launches per kernel)."""
    from oarfish_tpu_torch.ops.em_fast import _m_step_fast

    out, launched = {}, dict.fromkeys(KERNELS, 0)
    for impl in ("v4", "pallas"):
        line, res, run_launched = bench_main([], OARFISH_BENCH_IMPL=impl)
        data = res.form.data
        assert res.form.impl == impl and line["metric"] == "em_reads_per_sec"
        assert torch.cuda.get_device_name(device) in line["unit"]
        if impl == "v4":
            want = v4_launches(res.m_steps, data.seg_id is not None)
            step = em_v4.make_m_step(data, None)
            x = torch.nn.functional.pad(uniform_init(data, torch.float32),
                                        (0, data.t_space - T))
        else:
            want = dict.fromkeys(KERNELS, 0)
            want["sorted_gather"] = res.m_steps
            step = lambda p: _m_step_fast(data, p, None)  # noqa: E731
            x = uniform_init(data, torch.float32)
        assert run_launched == want, (impl, run_launched, want)
        mass = float(abs(res.counts.sum() - R) / R)
        assert mass < 1e-5, f"bench {impl}: mass off by {mass}"
        m_step_ms = queued_ms(lambda: step(x), device)
        limit = 5 * em_full[impl]["ms_per_iteration"]
        assert m_step_ms <= line["ms_per_iter"] <= limit, (
            impl, m_step_ms, line["ms_per_iter"], limit)
        out[impl] = dict(line=line, m_steps=res.m_steps,
                         launches=run_launched, mass_rel_err=mass,
                         m_step_ms=m_step_ms, ms_per_iter_limit=limit)
        for k, n in run_launched.items():
            launched[k] += n
        del data, res, step, x
        torch.cuda.empty_cache()

    # the end-to-end line: `auto` takes `pallas` at this size on the card
    line, _, run_launched = bench_main(
        ["--e2e", "--quick", "--reps", "1", "--work-dir",
         str(tmp / "bench_e2e")])
    assert line["metric"] == "e2e_bam_to_quant_s"
    runs = [line["cold"], line["warm"]]
    assert all(r["impl"] == "pallas" for r in runs), runs
    want = dict.fromkeys(KERNELS, 0)
    want["sorted_gather"] = sum(r["em_iters"] + 1 for r in runs)
    assert run_launched == want, (run_launched, want)
    meta = json.loads((tmp / "bench_e2e" / "out.meta_info.json").read_text())
    kept = int(meta["discard_table"]["valid_best_aln"])
    mass = max(abs(r["counts_sum"] - kept) / kept for r in runs)
    assert mass < 1e-5, f"bench --e2e: mass off by {mass}"
    out["e2e"] = dict(line=line, launches=run_launched, reads_kept=kept,
                      mass_rel_err=mass)
    for k, n in run_launched.items():
        launched[k] += n
    shutil.rmtree(tmp / "bench_e2e")
    emit("bench", **out)
    return out, launched


# `bench --e2e --boots`: the JAX system's 100 replicates, 12 batches of
# 8 slots; the replicates held bit for bit against their single runs:
# the first, the first of the pool's last 4, and the one with the most
# iterations
MODE_BOOTS = 100
MODE_SINGLES = (0, 96)


@contextlib.contextmanager
def recording_v4_replicates():
    """Keep the device state and read order of the last `EmV4Data.build`
    and the multiplicities and start of the last `run_replicates` made
    while the block runs."""
    kept = {}
    build, replicates = em_v4.EmV4Data.build, bootstrap_ops.run_replicates

    def record_build(*args, **kwargs):
        out = build(*args, **kwargs)
        kept["data"], kept["order"] = out
        return out

    def record_replicates(run, mult, init, *args, **kwargs):
        kept["mult"], kept["init"] = mult, init
        return replicates(run, mult, init, *args, **kwargs)

    em_v4.EmV4Data.build = staticmethod(record_build)
    bootstrap_ops.run_replicates = record_replicates
    try:
        yield kept
    finally:
        em_v4.EmV4Data.build = staticmethod(build)
        bootstrap_ops.run_replicates = replicates


def boots_launches(run: dict, fused: bool) -> dict:
    """Launches of one CLI run with replicates on v4: the point EM's
    m-steps, then the batch m-steps of the replicates' pool (one program
    each, the arms' launches among them; the span `boot.batches`)."""
    batched = run["bootstrap_msteps"]
    return v4_launches(run["em_iters"] + 1 + batched, fused, batched)


def phase_mode_bench(R, T, device, tmp: Path, capture, cli: dict) -> tuple:
    """The JAX system's three mode benchmarks through the port's bench
    entry point: (a) `--e2e --boots 100 --reps 1` on cli_e2e's BAM (not
    built again): 100 replicates written, finite, each within 1e-5 of the
    reads kept, exact launches over both runs, the multiplicities drawn
    again on the host (equal, timed), replicates 0, 96 and the one with
    the most iterations bit-equal to single `run_em_v4` runs with their
    multiplicities, one batch m-step of 4 bit-equal through the kernels
    and their plain versions; (b) `--sc` at the JAX script's defaults
    (dense on the card, no hand-written kernel; its BAM stays for the
    single_cell phase); (c) `--genome` at the JAX script's defaults, the
    CLI in a child process on the card, then the same command in this
    process: exact launches, every sorted gather bit-equal to its plain
    version, `.quant` and `.ambig_info.tsv` byte-equal to the child's.
    Returns (the phase's line, launches per kernel of (a) and (c)'s second
    run)."""
    import pyarrow.parquet as pq

    t_phase = time.time()
    work = tmp / "mode_bench"
    work.mkdir()
    os.link(tmp / "e2e.bam", work / f"e2e_R{R}_T{T}_s0.bam")
    (work / f"e2e_R{R}_T{T}_s0.json").write_text(json.dumps(
        {"R": R, "T": T, "A_generated": cli["records"]}))
    n_layout = len(capture.layout)
    t0 = time.time()
    with recording_v4_replicates() as kept:
        line, _, launched = bench_main(
            ["--e2e", "--boots", str(MODE_BOOTS), "--reps", "1",
             "--reads", str(R), "--txps", str(T), "--work-dir", str(work)])
    boots_s = time.time() - t0
    assert line["metric"] == "e2e_100boot_wall_s", line["metric"]
    assert line["replicates_written"] == MODE_BOOTS
    runs = [line["cold"], line["warm"]]
    assert all(r["impl"] == "v4" for r in runs), [r["impl"] for r in runs]
    layouts = capture.layout[n_layout:]
    assert len(layouts) == 2, layouts
    want = dict.fromkeys(KERNELS, 0)
    for run, (_, fused) in zip(runs, layouts):
        assert len(run["bootstrap_iterations"]) == MODE_BOOTS
        for k, n in boots_launches(run, fused).items():
            want[k] += n
    assert launched == want, (launched, want)
    # the run's replicates came from its draw stream: all its rows
    data, mult, init = kept["data"], kept["mult"][:], kept["init"]
    assert em_v4._batch_eligible(data), "the batches ran one by one"
    meta = json.loads((work / "out.meta_info.json").read_text())
    kept_reads = int(meta["discard_table"]["valid_best_aln"])
    reps = pq.read_table(str(work / "out.infreps.pq"))
    reps = np.stack([np.asarray(reps[c]) for c in reps.column_names])
    assert reps.shape == (MODE_BOOTS, T) and np.isfinite(reps).all()
    rep_mass = float(np.abs(reps.sum(axis=1) - kept_reads).max() / kept_reads)
    assert rep_mass < 1e-5, f"replicate mass off by {rep_mass}"
    # the draw again on the host, out of the run: the same multiplicities
    # from the run's seed, its seconds and bytes (inside `bootstrap_s`)
    defaults = Args()
    t0 = time.time()
    drawn = sample_multiplicities(np.random.default_rng(defaults.seed),
                                  MODE_BOOTS, kept_reads)
    draw_s = time.time() - t0
    t0 = time.time()
    drawn = drawn[:, kept["order"]]
    permute_s = time.time() - t0
    assert np.array_equal(drawn, mult), "the draw differs from the run's"
    draw = dict(draw_s=round(draw_s, 3), permute_s=round(permute_s, 3),
                gb=round(drawn.nbytes / 1e9, 3), equal_to_the_run=True)
    del drawn
    # launched after the main path's counts were read
    singles = {}
    slowest = int(np.argmax(line["bootstrap_iterations"]))
    for i in sorted({*MODE_SINGLES, slowest}):
        t0 = time.time()
        single, niter = em_v4.run_em_v4(
            data, init, defaults.max_em_iter, defaults.convergence_thresh,
            multiplicity=torch.as_tensor(mult[i], device=device).float())
        single = single.double().cpu().numpy()
        assert int(niter) == line["bootstrap_iterations"][i], (
            i, int(niter), line["bootstrap_iterations"][i])
        assert np.array_equal(reps[i], single), (
            f"replicate {i} differs from its single run (L1/R = "
            f"{float(np.abs(reps[i] - single).sum() / kept_reads)})")
        singles[i] = dict(iterations=int(niter), bit_equal=True,
                          single_s=round(time.time() - t0, 3))
    # one batch m-step of the last 4 replicates: the arms at B = 4
    tail = mult[BOOT_BATCH * (MODE_BOOTS // BOOT_BATCH):]
    m_b = torch.as_tensor(tail, device=device).float()
    prev = torch.nn.functional.pad(uniform_init(data, torch.float32),
                                   (0, data.t_space - T))
    prev_b = prev.expand(len(tail), -1).contiguous()
    arm_counters = [KERNELS[name][0] for name in ARMS]
    arms0 = [trace.counter(c) for c in arm_counters]
    got = em_v4.make_m_step(data, m_b)(prev_b)
    arms = tuple(trace.counter(c) - a for c, a in zip(arm_counters, arms0))
    assert arms == (2, 1), arms
    with plain_v4_kernels():
        plain = em_v4.make_m_step(data, m_b)(prev_b)
    arm_err = bit_equal("batch m-step of 4 replicates", got, plain)
    # a batch m-step of the last 4 replicates and of the 8 before them:
    # between CUDA events as a loop calls it, and queued back to back
    step_ms = {}
    for b, rows in ((len(tail), tail),
                    (BOOT_BATCH, mult[-len(tail) - BOOT_BATCH:-len(tail)])):
        m = torch.as_tensor(rows, device=device).float()
        x = prev.expand(b, -1).contiguous()
        step = em_v4.make_m_step(data, m)
        step_ms[f"b{b}"] = dict(ms=time_ms(lambda: step(x), device),
                                queued_ms=queued_ms(lambda: step(x), device))
    del data, mult, init, kept, got, plain, prev_b, m_b, m, x, step
    torch.cuda.empty_cache()
    shutil.rmtree(work)
    (tmp / "e2e.bam").unlink()
    boots = dict(line=line, launches=launched, seconds=round(boots_s, 1),
                 reads_kept=kept_reads, replicate_mass_rel_err=rep_mass,
                 draw=draw, singles_vs_batch=singles,
                 short_batch=dict(replicates=len(tail),
                                  arm_launches=dict(route_stage=arms[0],
                                                    route_middle=arms[1]),
                                  bit_equal=True, max_abs_err=arm_err,
                                  m_step_ms=step_ms))

    # (b) the single-cell line: `auto` takes dense on the card
    n_sc = len(capture.sc)
    t0 = time.time()
    sc_line, _, sc_launched = bench_main(["--sc", "--work-dir",
                                          str(tmp / "sc")])
    sc_s = time.time() - t0
    assert sc_line["metric"] == "sc_e2e_cells_per_s"
    assert not any(sc_launched.values()), sc_launched
    assert sc_line["cells"] == SC_CELLS and sc_line["nnz"] > 0, sc_line
    impls = {g[4] for p, g in capture.sc[n_sc:] if p is capture.SC_BUCKET}
    assert impls == {"dense"}, impls

    # (c) the genome line, then its command in this process
    gdir = tmp / "genome_bench"
    t0 = time.time()
    g_line, _, g_launched = bench_main(["--genome", "--work-dir", str(gdir)])
    assert g_line["metric"] == "genome_e2e_wall_s"
    assert not any(g_launched.values()), g_launched  # the child's, not ours
    assert g_line["truth_total"] == g_line["reads"]
    twin, _, _ = run_mode(bench_modes.genome_argv(gdir, g_line["threads"]),
                          gdir / "twin", device, capture)
    assert twin["k1_launches"] > 0, twin
    same = same_files(gdir / "out", gdir / "twin")
    genome_s = time.time() - t0
    shutil.rmtree(gdir)
    out = dict(e2e_boots=boots,
               sc=dict(line=sc_line, seconds=round(sc_s, 1)),
               genome=dict(line=g_line, spearman=g_line["spearman"],
                           in_process=twin, byte_equal_to_child=same,
                           seconds=round(genome_s, 1)),
               seconds=round(time.time() - t_phase, 1))
    emit("mode_bench", **out)
    return out, {k: launched[k] + twin["launches"][k] for k in KERNELS}


def read_mtx(path: Path):
    """(rows, cols, values, (n_rows, n_cols)) of a MatrixMarket file the
    single-cell writer wrote, 0-based."""
    with open(path, "rb") as fh:
        assert fh.readline().startswith(b"%%MatrixMarket"), path
        n_rows, n_cols, nnz = map(int, fh.readline().split())
        tok = np.array(fh.read().split()).reshape(-1, 3)
    assert len(tok) == nnz, (len(tok), nnz)
    return (tok[:, 0].astype(np.int64) - 1, tok[:, 1].astype(np.int64) - 1,
            tok[:, 2].astype(np.float64), (n_rows, n_cols))


def sparse_l1(a, b, n_cols: int) -> float:
    """Sum of |a - b| over the union of two matrices' entries."""
    keys = np.concatenate([a[0] * n_cols + a[1], b[0] * n_cols + b[1]])
    vals = np.concatenate([a[2], -b[2]])
    _, inv = np.unique(keys, return_inverse=True)
    return float(np.abs(np.bincount(inv, weights=vals)).sum())


def dense_m_step(bucket: dict, device) -> dict:
    """One dense m-step (`_m_step_dense`, f32) of a sub-batch at a
    bucket's shape, its cells filled to the padded widths: the profiler's
    device time and the time between CUDA events, against the least time
    of its work (S and R, the weights, `prev` read once, `curr` written
    once; four batched matrix-vector products at the f32 rate)."""
    a, r, t, sub = (bucket[k] for k in ("a_pad", "r_pad", "t_pad",
                                        "sub_batch"))
    rng = np.random.default_rng(4)
    txp = [rng.integers(0, t, a).astype(np.int32) for _ in range(sub)]
    rid = [np.sort(rng.integers(0, r, a)).astype(np.int32)
           for _ in range(sub)]
    w = [rng.random(a) for _ in range(sub)]
    sr = DenseCellEm.build(txp, w, rid, a, r, t, dtype=torch.float32,
                           device=device).densify()
    prev = torch.ones((sub, t), dtype=torch.float32, device=device)
    step = lambda: _m_step_dense(sr, prev)  # noqa: E731
    assert torch.isfinite(step()).all()
    return dict(
        a_pad=a, r_pad=r, t_pad=t, sub_batch=sub,
        device_ms=device_ms(step, device), ms=time_ms(step, device),
        **bound(nbytes(sr.S, sr.R, sr.weights, prev) + prev.numel() * 4,
                4 * sub * (a * t + r * a)))


def phase_single_cell(device, tmp: Path, capture) -> dict:
    """A CB-collated BAM at the JAX package's single-cell scale through
    the CLI with `--single-cell` on the card (`auto` -> dense), then again
    with `OARFISH_SC_IMPL=segsum` on the card: phases, cells/s, buckets,
    peak device memory; the matrix's mass against the reads kept, and the
    two runs against each other; then control runs of dense with less
    precise products, which the limit must tell from a sound one. This path launches none of the hand-written
    kernels (its products are `torch.bmm`)."""
    # the BAM of `bench --sc` in mode_bench, built there (or here) once
    work = tmp / "sc"
    work.mkdir(exist_ok=True)
    bam, n_alns, gen_s = bench_modes.ensure_sc_bam(
        work, SC_CELLS, SC_READS_PER_CELL, SC_TXPS)
    runs, mats = {}, {}
    for impl, want_impl in (("auto", "dense"), ("segsum", "segsum")):
        out = tmp / f"sc_{impl}"
        n_sc, warn0 = len(capture.sc), len(capture.warnings)
        os.environ["OARFISH_SC_IMPL"] = impl
        torch.cuda.reset_peak_memory_stats(device)
        reset_launch_counts()
        t0 = time.time()
        try:
            rc = cli_main(["--alignments", str(bam), "-o", str(out),
                           "--single-cell"])
            torch.cuda.synchronize(device)
        finally:
            del os.environ["OARFISH_SC_IMPL"]
        wall = time.time() - t0
        launched = launch_counts()
        assert rc == 0
        assert not any(launched.values()), launched
        assert not capture.warnings[warn0:], capture.warnings[warn0:]
        logged = capture.sc[n_sc:]
        phases = {g[0]: float(g[1]) for p, g in logged
                  if p is capture.SC_PHASE}
        (cells, empty, reads), = [tuple(map(int, g)) for p, g in logged
                                  if p is capture.SC_PARSED]
        buckets = [dict(a_pad=int(g[0]), r_pad=int(g[1]), t_pad=int(g[2]),
                        cells=int(g[3]), impl=g[4], sub_batches=int(g[5]),
                        sub_batch=int(g[6]), s=float(g[7]))
                   for p, g in logged if p is capture.SC_BUCKET]
        assert {b["impl"] for b in buckets} == {want_impl}, buckets
        assert cells == SC_CELLS and sum(b["cells"] for b in buckets) == (
            cells - empty), (cells, empty, buckets)
        rows, cols, vals, shape = read_mtx(Path(str(out) + ".count.mtx"))
        assert shape == (cells, SC_TXPS), shape
        assert np.isfinite(vals).all() and (vals > 0).all()
        n_bc = len(Path(str(out) + ".barcodes.txt").read_text().splitlines())
        assert n_bc == cells, n_bc
        mass_err = abs(vals.sum() - reads) / reads
        assert mass_err < 1e-5, f"{impl}: mass {vals.sum()} vs {reads} reads"
        runs[want_impl] = dict(
            wall_s=round(wall, 3), cells_per_s=cells / wall,
            phases_s=phases, cells=cells, empty_cells=empty,
            reads_kept=reads, nnz=len(vals), buckets=buckets,
            max_memory_allocated_mb=round(
                torch.cuda.max_memory_allocated(device) / 2**20, 1),
            mass_rel_err=mass_err)
        mats[want_impl] = (rows, cols, vals)
    l1 = sparse_l1(mats["dense"], mats["segsum"], SC_TXPS) / reads
    assert l1 < SC_DENSE_VS_SEGSUM, f"dense vs segsum L1/R = {l1}"
    # controls, the dense path with less precise products, which the limit
    # must tell from a sound run: TF32 allowed (printed only: cuBLAS runs
    # these matrix-vector products without it), and `prev` rounded to bf16
    # before every m-step (gated: it must land over the limit)
    def control(tag, tf32=False, m_step=None):
        os.environ["OARFISH_SC_IMPL"] = "dense"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        if m_step is not None:
            em_dense._m_step_dense = m_step
        try:
            assert cli_main(["--alignments", str(bam), "-o",
                             str(tmp / f"sc_{tag}"), "--single-cell"]) == 0
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            em_dense._m_step_dense = _m_step_dense
            del os.environ["OARFISH_SC_IMPL"]
        got = read_mtx(Path(str(tmp / f"sc_{tag}") + ".count.mtx"))[:3]
        return sparse_l1(got, mats["segsum"], SC_TXPS) / reads

    l1_tf32 = control("tf32", tf32=True)
    l1_bf16 = control("bf16_prev", m_step=lambda data, prev: _m_step_dense(
        data, prev.to(torch.bfloat16).to(prev.dtype)))
    assert l1_bf16 >= SC_DENSE_VS_SEGSUM, (
        f"the limit {SC_DENSE_VS_SEGSUM} passes a run with bf16 prev "
        f"(L1/R {l1_bf16})")
    top = max(runs["dense"]["buckets"], key=lambda b: b["cells"])
    res = dict(
        cells=SC_CELLS, reads_per_cell=SC_READS_PER_CELL, T=SC_TXPS,
        records=n_alns, bam_mb=round(bam.stat().st_size / 2**20, 1),
        bam_build_s=round(gen_s, 2), **runs,
        l1_over_R_dense_vs_segsum=l1, l1_over_R_limit=SC_DENSE_VS_SEGSUM,
        control_tf32_l1_over_R_vs_segsum=l1_tf32,
        control_bf16_prev_l1_over_R_vs_segsum=l1_bf16,
        dense_m_step_most_populous_bucket=dense_m_step(top, device))
    shutil.rmtree(work)
    emit("single_cell", **res)
    return res



# the set-up phases a run logs in sequence (genome-read mode logs its
# annotation and g2t phases as overlapped with the index build)
SETUP_PHASES = {
    "reads": ("rawreads.index", "genome.index", "genome.aux"),
    "genome_bam": ("genome.annot", "genome.g2t", "genome.rescue",
                   "genome.flatg2t"),
}


@contextlib.contextmanager
def recording_k1():
    """Keep the inputs and the output of every sorted-gather call the EM
    makes while the block runs, so that each launch of a run can be held
    afterwards against the plain version on the same inputs."""
    calls = []
    real = em_fast.gather_rows

    def record(table, base, code, table_rows):
        out = real(table, base, code, table_rows)
        calls.append((table, base, code, table_rows, out))
        return out

    em_fast.gather_rows = record
    try:
        yield calls
    finally:
        em_fast.gather_rows = real


def k1_calls_equal_plain(calls) -> dict:
    """Each recorded launch's output bit for bit against the plain version
    on its own inputs (the run's table of each m-step and its plan)."""
    err = 0.0
    for tab, base, code, table_rows, out in calls:
        err = max(err, bit_equal(
            "sorted_gather in the run", out,
            sg.gather_rows_reference(tab, base, code, table_rows)))
    tab, base, _, table_rows = calls[0][:4]
    return dict(calls=len(calls), n_rows=int(base.shape[0]),
                table_rows=table_rows, table_len=int(tab.shape[-1]),
                dtype=str(tab.dtype), bit_equal=True, max_abs_err=err)


def run_mode(argv, out: Path, device, capture, setup="reads"):
    """One run of the CLI in a raw-read or genome mode on the card with
    its defaults. Returns (its line, the counts of `.quant`, the reads
    kept): wall seconds, the mode's logged phase seconds, what the EM
    formulation resolved to, iterations, EM seconds and their share of the
    wall (the card's busy share at most), alignments, threads, launches,
    which must be exact (per m-step one sorted gather under `pallas`, the
    v4 counts under `v4`, none under `segsum`), every sorted gather of the
    run bit-equal to its plain version on the run's own inputs, and the
    mass gate."""
    n_em, n_auto, n_layout = (len(capture.em), len(capture.auto),
                              len(capture.layout))
    n_phase, n_rec, warn0 = (len(capture.mode_phases), len(capture.records),
                             len(capture.warnings))
    with recording_k1() as k1_calls:
        reset_launch_counts()
        t0 = time.time()
        rc = cli_main([*argv, "-o", str(out)])
        torch.cuda.synchronize(device)
        wall = time.time() - t0
        launched = launch_counts()
    assert rc == 0
    assert not capture.warnings[warn0:], capture.warnings[warn0:]
    (impl, iters, em_s), = capture.em[n_em:]
    want = dict.fromkeys(KERNELS, 0)
    if impl == "pallas":
        want["sorted_gather"] = iters + 1
    elif impl == "v4":
        assert len(capture.layout) == n_layout + 1
        want = v4_launches(iters + 1, capture.layout[-1][1])
    assert launched == want, (impl, iters, launched, want)
    assert len(k1_calls) == launched["sorted_gather"], len(k1_calls)
    k1 = k1_calls_equal_plain(k1_calls) if k1_calls else None
    del k1_calls
    for ext in (".quant", ".ambig_info.tsv", ".meta_info.json"):
        assert Path(str(out) + ext).stat().st_size > 0, ext
    counts = read_quant(str(out) + ".quant")
    assert np.isfinite(counts).all() and (counts >= 0).all()
    meta = json.loads(Path(str(out) + ".meta_info.json").read_text())
    kept = int(meta["discard_table"]["valid_best_aln"])
    mass_err = abs(counts.sum() - kept) / kept
    assert mass_err < 1e-5, f"mass {counts.sum()} vs {kept} reads kept"
    phases = dict(capture.mode_phases[n_phase:])
    # set-up: the index build or load (with the g2t index and the rescue
    # blob in genome-read mode), or the annotation, g2t index, rescue
    # database and flat g2t of genome-BAM mode; alignment: mapping (and
    # projection), or the genome BAM's parse and projection; rest: the
    # EM's layout, digests and writing
    setup_s = sum(phases.get(k, 0.0) for k in SETUP_PHASES[setup])
    aln_s = float(meta["alignment_time"]["seconds"])
    line = dict(
        wall_s=round(wall, 3), phases_s=phases, setup_s=round(setup_s, 3),
        alignment_s=round(aln_s, 3),
        rest_s=round(wall - setup_s - aln_s - em_s, 3),
        em_impl=impl, auto=capture.auto[n_auto:] == [impl],
        iterations=iters, em_s=em_s, em_share_of_wall=em_s / wall,
        alignments=capture.records[n_rec], reads_kept=kept,
        threads=meta["threads"], launches=launched,
        k1_launches=launched["sorted_gather"], k1_vs_plain=k1,
        mass_rel_err=mass_err)
    return line, counts, kept


def ambiguous_reads(prefix: Path) -> int:
    """Reads of a run that its `.ambig_info.tsv` counts at more than one
    transcript (the reads kept less the sum of its unique column)."""
    rows = np.loadtxt(str(prefix) + ".ambig_info.tsv", skiprows=1, ndmin=2)
    meta = json.loads(Path(str(prefix) + ".meta_info.json").read_text())
    return int(meta["discard_table"]["valid_best_aln"] - rows[:, 0].sum())


def same_files(a: Path, b: Path, exts=(".quant", ".ambig_info.tsv")):
    for ext in exts:
        assert (Path(str(a) + ext).read_bytes()
                == Path(str(b) + ext).read_bytes()), (a, b, ext)
    return True


def phase_raw_reads(device, tmp: Path, capture):
    """Raw reads against a transcriptome at the raw-read bench's scale:
    the CLI with its defaults on the card, building the index from the
    FASTA (and writing it), then on that index (`.quant` and
    `.ambig_info.tsv` byte-equal), then on that index with `--em-impl
    segsum` (L1/R against the index run). Returns (the phase's line,
    launches per kernel in the phase)."""
    d = tmp / "raw_reads"
    d.mkdir()
    rng = np.random.default_rng(1)
    t0 = time.time()
    blob, offs, lens = build_transcriptome(d, rng, RR_TXPS)
    truth = simulate_raw_reads(d, rng, blob, offs, lens, RR_READS,
                               RR_EXPRESSED)
    del blob
    gen_s = time.time() - t0
    reads = ["--reads", str(d / "reads.fa"), "--seq-tech", "ont-cdna"]
    idx = d / "txps.otmi"
    fasta, c_fasta, kept = run_mode(
        reads + ["--annotated", str(d / "txps.fa"), "--index-out", str(idx)],
        d / "fasta", device, capture)
    index, c_index, _ = run_mode(reads + ["--index", str(idx)], d / "index",
                                 device, capture)
    same = same_files(d / "fasta", d / "index")
    segsum, c_segsum, _ = run_mode(
        reads + ["--index", str(idx), "--em-impl", "segsum"], d / "segsum",
        device, capture)
    assert segsum["em_impl"] == "segsum"
    l1 = float(np.abs(c_segsum - c_index).sum() / kept)
    assert l1 < L1_OVER_R_LIMIT, f"segsum vs the index run: L1/R = {l1}"
    # the isoform families leave the EM reads to share out
    ambiguous = ambiguous_reads(d / "fasta")
    assert ambiguous > 0
    res = dict(
        T=RR_TXPS, transcriptome_mbp=round(int(offs[-1]) / 1e6, 1),
        reads=RR_READS, expressed=RR_EXPRESSED, world_build_s=round(gen_s, 2),
        index_mb=round(idx.stat().st_size / 2**20, 1),
        fasta=fasta, index=index, segsum=segsum,
        index_run_byte_equal=same, ambiguous_reads=ambiguous,
        l1_over_R_segsum_vs_index=l1, l1_over_R_limit=L1_OVER_R_LIMIT,
        pearson_vs_truth=float(np.corrcoef(c_fasta, truth)[0, 1]))
    emit("raw_reads", **res)
    shutil.rmtree(d)
    launches = {k: sum(r["launches"][k] for r in (fasta, index, segsum))
                for k in KERNELS}
    return res, launches


def phase_genome(device, tmp: Path, capture):
    """Raw reads against a genome at the genome bench's scale (`--reads
    --genome --annotation`), from the FASTA (writing the index), then
    from that index (outputs byte-equal), then from that index with
    `--em-impl segsum` (L1/R against the index run); then the same reads
    as a genome BAM with their true alignments (`--genome-alignments`,
    rescue on through `--genome-fasta`). Returns (the two phases' lines,
    launches per kernel in each)."""
    d = tmp / "genome"
    d.mkdir()
    rng = np.random.default_rng(1)
    t0 = time.time()
    sample = rng.choice(G_GENES, size=G_SAMPLE_GENES, replace=False)
    *chroms, isoforms = build_genome_world(d, rng, G_GENES, G_CHROMS, sample)
    bam_bytes = simulate_genome_reads(d, rng, isoforms, chroms, G_READS)
    del isoforms
    gen_s = time.time() - t0
    genome_mbp = round(sum(chroms[1]) / 1e6, 1)
    anno = ["--annotation", str(d / "anno.gtf")]
    reads = ["--reads", str(d / "reads.fa"), "--seq-tech", "ont-cdna", *anno]
    gidx = d / "genome.otmi"
    fasta, c_fasta, _ = run_mode(
        reads + ["--genome", str(d / "genome.fa"), "--index-out", str(gidx)],
        d / "fasta", device, capture)
    index, c_index, kept_reads = run_mode(
        reads + ["--genome", str(gidx)], d / "index", device, capture)
    same = same_files(d / "fasta", d / "index")
    segsum, c_segsum, _ = run_mode(
        reads + ["--genome", str(gidx), "--em-impl", "segsum"],
        d / "segsum", device, capture)
    assert segsum["em_impl"] == "segsum"
    l1 = float(np.abs(c_segsum - c_index).sum() / kept_reads)
    assert l1 < L1_OVER_R_LIMIT, f"segsum vs the index run: L1/R = {l1}"
    ambiguous = ambiguous_reads(d / "fasta")
    assert ambiguous > 0
    res_reads = dict(
        genes=G_GENES, isoforms=2 * G_GENES, chroms=len(chroms[0]),
        genome_mbp=genome_mbp, reads=G_READS, sampled_genes=G_SAMPLE_GENES,
        world_build_s=round(gen_s, 2),
        index_mb=round(gidx.stat().st_size / 2**20, 1),
        fasta=fasta, index=index, segsum=segsum, index_run_byte_equal=same,
        ambiguous_reads=ambiguous,
        l1_over_R_segsum_vs_index=l1, l1_over_R_limit=L1_OVER_R_LIMIT)
    emit("genome_reads", **res_reads)
    gidx.unlink()

    bam, c_bam, kept = run_mode(
        ["--genome-alignments", str(d / "g.bam"), *anno, "--genome-fasta",
         str(d / "genome.fa")], d / "bam", device, capture,
        setup="genome_bam")
    res_bam = dict(
        reads=G_READS, genome_mbp=genome_mbp,
        bam_mb=round(bam_bytes / 2**20, 1), run=bam,
        ambiguous_reads=ambiguous_reads(d / "bam"),
        l1_over_R_vs_genome_reads=float(np.abs(c_bam - c_fasta).sum()
                                        / kept))
    emit("genome_bam", **res_bam)
    shutil.rmtree(d)
    return ((res_reads, res_bam),
            ({k: sum(r["launches"][k] for r in (fasta, index, segsum))
              for k in KERNELS}, bam["launches"]))


def phase_covmodel_device_vs_host(bam: Path, argv, kept: int, device) -> dict:
    """The coverage model of the CLI run's own store: `models/coverage_torch`
    on the card against the native host pass, rtol 1e-12 on the per-bin
    probabilities and on the per-alignment coverage probabilities; the
    seconds of both (the device's with its copies to and from the card).
    The device model's prefix sums are the host's serial ones."""
    args = to_args(build_parser().parse_args(argv))
    t0 = time.time()
    _, store, coverage, _ = pack_bam_fast(
        bam, resolve_filters(args), bin_width=args.bin_width,
        threads=max(args.threads, 1),
    )
    pack_s = time.time() - t0
    assert store.num_reads == kept

    def fresh():
        cov = TranscriptCoverage(coverage.txp_len, args.bin_width)
        cov.bins[:] = coverage.bins
        cov.total_weight[:] = coverage.total_weight
        return cov

    def host():
        cov = fresh()
        t0 = time.time()
        flat = covmodel_host.logistic_prob(cov, args.growth_rate,
                                           threads=args.threads)
        covmodel_host.normalize_read_probs(store, cov, flat, args.bin_width,
                                           threads=args.threads)
        return time.time() - t0, flat, cov.bins, store.cov_prob.copy()

    def on_device():
        cov = fresh()
        torch.cuda.synchronize(device)
        t0 = time.time()
        flat = covmodel_device.logistic_prob_torch(cov, args.growth_rate,
                                                   device=device)
        covmodel_device.normalize_read_probs_torch(
            store, cov, flat, args.bin_width, device=device)
        torch.cuda.synchronize(device)
        return time.time() - t0, flat, cov.bins, store.cov_prob.copy()

    def rel_dev(got, want):
        nz = want != 0
        return float((np.abs(got[nz] - want[nz]) / np.abs(want[nz])).max())

    host_s, flat_h, bins_h, prob_h = host()
    first_s, flat_d, bins_d, prob_d = on_device()
    np.testing.assert_allclose(flat_d, flat_h, rtol=1e-12, atol=0)
    np.testing.assert_allclose(bins_d, bins_h, rtol=1e-15, atol=0)
    np.testing.assert_allclose(prob_d, prob_h, rtol=1e-12, atol=0)
    device_s, _, _, again = on_device()
    assert np.array_equal(again, prob_d), "two device passes differ"
    res = dict(
        alignments=int(store.num_alignments), reads=int(store.num_reads),
        bins=int(len(flat_h)), prefix_sum_max=float(flat_h.sum()),
        repack_s=round(pack_s, 2), host_s=host_s, host_threads=args.threads,
        device_first_s=first_s, device_s=device_s, rtol=1e-12,
        max_rel_dev_bin_prob=rel_dev(flat_d, flat_h),
        max_rel_dev_cov_prob=rel_dev(prob_d, prob_h),
    )
    emit("covmodel_device_vs_host", **res)
    return res


def measure_m_step(tag, m_step, init, device, profile_dir,
                   once: str) -> dict:
    """An m-step alone (ms per call between CUDA events), 200 loop
    iterations with the host reading the stop flag every iteration
    against never reading it, and, with `profile_dir`, the m-step's kernel
    launches and device time by name: a window of 20 calls, its m-steps
    counted by the kernel `once`, which each launches once (`per_step`)."""
    from oarfish_tpu_torch.ops.em import em_loop

    def loop(min_iters):
        t0 = time.perf_counter()
        em_loop(m_step, init, 200, 0.0, min_iters=min_iters)
        torch.cuda.synchronize(device)
        return (time.perf_counter() - t0) / 200 * 1e3

    loop(10**9)  # warm up
    never, every = [], []
    for _ in range(3):  # in turns, so that clocks and neighbours even out
        never.append(loop(10**9))
        every.append(loop(0))
    res = dict(
        m_step_ms=time_ms(lambda: m_step(init), device),
        loop_ms_per_iter_never_read=float(np.median(never)),
        loop_ms_per_iter_read_every_iter=float(np.median(every)),
        loop_ms_per_iter_runs=dict(never_read=never, read_every_iter=every),
    )
    got = None
    if profile_dir is not None:
        got = profile_steps(lambda: m_step(init), device, 20, once=once)
        res["m_step_device_ms"] = None  # not measured, unless whole
    if got is not None:
        by_time = sorted(got["device_us_per_step"].items(),
                         key=lambda kv: -kv[1])
        Path(profile_dir).mkdir(parents=True, exist_ok=True)
        path = Path(profile_dir) / f"m_step_kernels_{tag}.json"
        with open(path, "w") as fh:
            json.dump([dict(name=name[:160],
                            calls_per_step=got["calls_per_step"][name],
                            device_us_per_step=us)
                       for name, us in by_time], fh, indent=1)
        res["profile"] = str(path)
        res["profile_m_steps"] = got["steps"]
        res["m_step_launches"] = got["launches"]
        res["m_step_device_ms"] = got["device_ms"]
        res["device_us_by_kernel"] = {
            name[:48]: round(us, 1) for name, us in by_time[:10]}
    return res


def phase_em_breakdown(csr, T, device, profile_dir) -> dict:
    """Where an EM iteration's time goes at full width (f32), for the
    `pallas` layout and for the routed `v4` one, in one process."""
    from oarfish_tpu_torch.ops.em_fast import _m_step_fast

    txp_id, w, boundaries, A = csr
    data, _ = FastEmData.build(
        txp_id, w, boundaries, T, dtype=torch.float32,
        use_pallas_gather=True, device=device,
    )
    init = uniform_init(data, torch.float32)
    mult8 = torch.ones((8, data.num_reads), device=device)
    res = {"pallas": measure_m_step(
        "pallas", lambda p: _m_step_fast(data, p, None), init, device,
        profile_dir, once="sorted_gather_kernel")}
    res["pallas"]["m_step_8_replicates_ms"] = time_ms(
        lambda: _m_step_fast(data, init.expand(8, -1), mult8), device)
    del data

    v4, _ = em_v4.EmV4Data.build(txp_id, w, boundaries, T, device=device)
    ext = torch.nn.functional.pad(init, (0, v4.t_space - T))
    res["v4"] = measure_m_step(
        "v4", em_v4.make_m_step(v4, None), ext, device, profile_dir,
        once="route_middle_kernel")
    mult1 = torch.ones(v4.row_space_r, device=device)
    replicate_step = em_v4.make_m_step(v4, mult1)
    res["v4"]["m_step_replicate_ms"] = time_ms(
        lambda: replicate_step(ext), device)
    # one bootstrap batch as one program
    mult8 = torch.ones((REPLICATES, v4.row_space_r), device=device)
    res["v4_batch"] = dict(
        replicates=REPLICATES,
        **measure_m_step("v4_batch", em_v4.make_m_step(v4, mult8),
                         ext.expand(REPLICATES, -1).contiguous(), device,
                         profile_dir, once="route_middle_kernel"))
    emit("em_breakdown", **res)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--breakdown", action="store_true",
                    help="also time the pallas and the v4 m-step alone and "
                    "the loop with and without the per-iteration read of "
                    "the stop flag")
    ap.add_argument("--profile-dir", default=None,
                    help="with --breakdown: write the m-steps' kernel times "
                    "by name (torch.profiler) into this directory")
    ns = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    R, T = FULL_READS, FULL_TXPS

    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    capture = EmLogCapture()
    logging.getLogger("oarfish_tpu_torch").addHandler(capture)

    t_start = time.time()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    # the plan cache is on, as for a user, but kept inside this run
    os.environ["OARFISH_PLAN_CACHE"] = "1"
    os.environ["OARFISH_PLAN_CACHE_DIR"] = str(tmp / "plans")
    try:
        smi = phase_env()
        txp_id, w, boundaries, _, A = make_csr(R, T, seed=0)
        csr = (txp_id, w, boundaries, A)
        phase_kernels()
        k1 = phase_k1_vs_plain(csr, T, device)
        k234 = phase_k2_k3_k4_vs_plain(csr, R, T, device)

        # the main paths: each run sets the launch counts to 0 before it
        # drives the port and reads them before any comparison
        em_full, launches_em, counts_em = phase_em_full_width(
            csr, R, T, device, tmp, capture,
            fused=k234["plan"]["fused_middle"])
        phase_segsum_replicates(csr, R, T, device)
        v3, launches_v3 = phase_em_v3(csr, R, T, device, tmp, capture,
                                      counts_em)
        cli, launches_cli = phase_cli_e2e(R, T, device, tmp, capture)
        _, launches_profile = phase_cli_profile(device, tmp, capture, cli)
        _, launches_sharded = phase_sharded(
            csr, R, T, device, tmp, capture, counts_em["v4"],
            tmp / "e2e.bam")
        _, launches_bench = phase_bench(R, T, device, tmp, em_full)
        _, launches_mode = phase_mode_bench(R, T, device, tmp, capture, cli)
        phase_single_cell(device, tmp, capture)
        raw, launches_raw = phase_raw_reads(device, tmp, capture)
        (greads, gbam), (launches_greads, launches_gbam) = phase_genome(
            device, tmp, capture)
        if ns.breakdown:
            phase_em_breakdown(csr, T, device, ns.profile_dir)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    by_path = {"em_full_width": launches_em, "em_v3": launches_v3,
               "cli_e2e": launches_cli, "cli_profile": launches_profile,
               "sharded": launches_sharded,
               "bench": launches_bench, "mode_bench": launches_mode,
               "raw_reads": launches_raw, "genome_reads": launches_greads,
               "genome_bam": launches_gbam}
    # the raw-read and genome runs end in the same tail: at their sizes it
    # takes `pallas` (each run's count was checked against its iterations)
    for path in ("raw_reads", "genome_reads", "genome_bam"):
        if by_path[path]["sorted_gather"] == 0:
            raise AssertionError(f"{path} never launched sorted_gather")
    # every sorted gather of those runs was held against its plain version
    mode_runs = [raw["fasta"], raw["index"], raw["segsum"], greads["fasta"],
                 greads["index"], greads["segsum"], gbam["run"]]
    k1_mode_err = max(r["k1_vs_plain"]["max_abs_err"] for r in mode_runs
                      if r["k1_vs_plain"] is not None)

    def entry(name, measured, **extra):
        _, source, replaces = KERNELS[name]
        # the arms are launched by the 8 replicates of `em_full_width` and
        # by the CLI's 100 of `mode_bench`
        paths = ((launches_em, launches_mode) if name in ARMS
                 else (launches_em, launches_cli))
        if any(path[name] == 0 for path in paths):
            raise AssertionError(f"a main path never launched {name}")
        return {
            "name": name, "route": "cuda",
            "source": f"oarfish_tpu_torch/csrc/{source}",
            "replaces": f"{JAX_PACKAGE}/{replaces}",
            "launches": sum(path[name] for path in by_path.values()),
            "launches_by_path": {k: v[name] for k, v in by_path.items()},
            **{k: measured[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by", "library_ms")},
            **extra,
        }

    def also(measured, tag):
        return {f"{k}_{tag}": measured[k]
                for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                          "device_ms_l2_flushed", *DEVICE_TIMES)
                if k in measured}

    def device_times(measured):
        return {k: measured[k] for k in DEVICE_TIMES if k in measured}

    k2, k3, k4 = (k234[k] for k in ("tile_permute", "route_stage",
                                    "route_middle"))
    # v3's shapes: K1 on its interleaved plan, K2 at R1 / R3 rows
    v3k1, v3k2 = (v3["kernels"][k] for k in ("sorted_gather",
                                             "tile_permute"))
    v3_k2 = {}
    for stage, m in v3k2.items():
        v3_k2.update(also(m, "v3_" + stage.replace(".", "_")))
    reduce_tag = next(t for t in k3 if t.startswith("reduce"))
    kernels = [
        entry("sorted_gather",
              dict(k1, max_abs_err=max(
                  k1["max_abs_err"], k1_mode_err, v3k1["max_abs_err"],
                  cli["pallas_run"]["k1_plan"]["max_abs_err"])),
              **device_times(k1), ms_8_replicates=k1["ms_b8"],
              bound_ms_8_replicates=k1["bound_ms_b8"],
              device_ms_l2_flushed=k1["device_ms_l2_flushed"],
              device_ms_8_replicates=k1["device_ms_b8"],
              library_ms_8_replicates=k1["library_ms_b8"],
              library_device_ms_8_replicates=k1["library_device_ms_b8"],
              bound_ms_old_form=k1["bound_ms_old_form"],
              bound_ms_8_replicates_old_form=k1["bound_ms_b8_old_form"],
              probe_device_ms=k1["probe_device_ms"],
              bound_ms_old_form_v3=v3k1["bound_ms_old_form"],
              **also(v3k1, "v3")),
        entry("tile_permute",
              dict(k2["t_in"], max_abs_err=max(
                  v["max_abs_err"]
                  for v in (*k2.values(), *v3k2.values()))),
              measured_on="t_in", **device_times(k2["t_in"]),
              **also(k2["t_out"], "t_out"),
              **also(k2["t_in_x8"], "8_replicates"), **v3_k2),
        entry("route_stage",
              dict(k3["expand_y1_mul"], max_abs_err=max(
                  v["max_abs_err"] for v in k3.values())),
              measured_on="expand_y1 with mul",
              **device_times(k3["expand_y1_mul"]),
              **also(k3[reduce_tag], reduce_tag)),
    ]
    if k4:  # a plan without a level table never launches the fused middle
        kernels.append(entry(
            "route_middle",
            dict(k4["point"], max_abs_err=max(
                v["max_abs_err"] for v in k4.values())),
            measured_on="point estimate (no mult)",
            **device_times(k4["point"]),
            **also(k4["replicate"], "replicate")))
    arm3, arm4 = k234["route_stage_replicates"], k234["route_middle_replicates"]
    kernels.append(entry(
        "route_stage_replicates",
        dict(arm3["expand_y1_mul"], max_abs_err=max(
            v["max_abs_err"] for v in arm3.values())),
        replicates=REPLICATES, measured_on="expand_y1 with mul",
        **device_times(arm3["expand_y1_mul"]),
        **also(arm3["reduce_strided"], "reduce_strided")))
    kernels.append(entry(
        "route_middle_replicates",
        dict(arm4["point"], max_abs_err=max(
            v["max_abs_err"] for v in arm4.values())),
        replicates=REPLICATES, measured_on="no mult",
        **device_times(arm4["point"]),
        **also(arm4["replicate"], "replicate")))
    row = k234["row_sums"]
    kernels.append(entry(
        "row_sums", row, measured_on="the transcript tail of an m-step, one "
        "launch (bucket sums, big transcripts' second level, zero pad)",
        **device_times(row),
        **{k: row[k] for k in row
           if k.startswith(("plan", "launches_per", "library_max",
                            "device_ms_l2"))
           or k.endswith("_8_replicates")}))
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("total", seconds=round(time.time() - t_start, 1))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
