"""The comparison that decides `correct`: each job's files against the
plain reference (`perfbench/reference/`), worked out again from the
job's input records and the seed.

Bulk, for every job: the reads kept (`.meta_info.json`'s discard table)
and the alignments kept per transcript (`.ambig_info.tsv`) exactly; the
point EM (`.quant`) and a sample of the bootstrap replicates
(`.infreps.pq`, replicates drawn from the run's seed) by the L1 distance
to the reference's counts over the reads kept; and that every replicate
was written. Single-cell, for every job: the cells and their barcodes
(`.count.mtx`'s size line, `.barcodes.txt`) exactly, and the matrix by
its L1 distance to the reference's per-cell EMs over the reads kept.

Each number is the worst over the run's jobs and has a limit of its own,
from the cell's traffic file (`limits`); `PERF.md` gives the readings
each limit was set from.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

import numpy as np

from .gen.bam import barcode_of
from .reference import em as ref_em
from .reference.filters import aux_counts, filter_records


def _with(prefix, ext: str) -> Path:
    return Path(str(prefix) + ext)


def read_quant(prefix) -> np.ndarray:
    lines = _with(prefix, ".quant").read_bytes().split(b"\n")
    return np.array([ln.rsplit(b"\t", 1)[1] for ln in lines[1:] if ln],
                    dtype=np.float64)


def read_ambig(prefix):
    body = _with(prefix, ".ambig_info.tsv").read_bytes().split(b"\n", 1)[1]
    a = np.array(body.split(), dtype=np.int64).reshape(-1, 3)
    return a[:, 0], a[:, 2]


def read_meta(prefix) -> dict:
    return json.loads(_with(prefix, ".meta_info.json").read_text())


def read_infreps(prefix, wanted: List[int]):
    """(the replicate columns written, {i: counts of `bootstrap.i`} for
    the `wanted` ones that were)."""
    import pyarrow.parquet as pq

    path = _with(prefix, ".infreps.pq")
    names = pq.read_schema(str(path)).names
    cols = [f"bootstrap.{i}" for i in wanted if f"bootstrap.{i}" in names]
    table = pq.read_table(str(path), columns=cols)
    return names, {int(c.split(".")[1]): table.column(c).to_numpy()
                   for c in cols}


def read_mtx(prefix):
    """(rows, cols, values, number of rows) of `.count.mtx`, 0-based."""
    data = _with(prefix, ".count.mtx").read_bytes()
    lines = data.split(b"\n", 2)
    num_rows, _, nnz = (int(x) for x in lines[1].split())
    a = np.array(lines[2].split(), dtype=np.float64).reshape(-1, 3)
    if len(a) != nnz:
        raise ValueError(f".count.mtx has {len(a)} entries, says {nnz}")
    return (a[:, 0].astype(np.int64) - 1, a[:, 1].astype(np.int64) - 1,
            a[:, 2], num_rows)


def sparse_l1(keys_a, vals_a, keys_b, vals_b) -> float:
    """The L1 distance of two sparse vectors given as (key, value)."""
    keys = np.concatenate([keys_a, keys_b])
    vals = np.concatenate([vals_a, -np.asarray(vals_b, np.float64)])
    _, inv = np.unique(keys, return_inverse=True)
    return float(np.abs(np.bincount(inv, weights=vals)).sum())


@dataclass
class Numbers:
    """The numbers compared, each the worst over the jobs, and their
    limits."""

    limits: Dict[str, float]
    values: Dict[str, float] = field(default_factory=dict)
    errors: List[str] = field(default_factory=list)

    def see(self, name: str, value: float) -> None:
        self.values[name] = max(self.values.get(name, 0.0), float(value))

    def correct(self) -> bool:
        return all(name in self.values and self.values[name] <= lim
                   for name, lim in self.limits.items())

    def report(self) -> Dict[str, dict]:
        """Each number beside its limit; a number that could not be read
        (a job that failed) is null, which JSON can carry."""
        def finite(v):
            return v if v is not None and np.isfinite(v) else None

        return {name: {"value": finite(self.values.get(name)),
                       "limit": lim}
                for name, lim in self.limits.items()}


def load_records(bam: Path) -> dict:
    with np.load(str(bam) + ".npz") as z:
        return {k: z[k] for k in z.files}


class BulkExpected:
    """What a bulk job of one input must give: reads and alignments kept,
    the point EM, and the sampled replicates' EMs."""

    def __init__(self, bam: Path, num_boot: int, draw, sample: List[int],
                 device, dtype):
        import torch

        rec = load_records(bam)
        kept = filter_records(rec)
        self.T = len(rec["t_len"])
        self.reads = kept.num_reads
        self.valid_best_aln = kept.valid_best_aln
        self.unique, self.total = aux_counts(kept, self.T)
        csr = ref_em.bulk_csr(kept, self.T, device, dtype)
        init = torch.full((1, self.T), self.reads / self.T, dtype=dtype,
                          device=device)
        self.counts = ref_em.run_em(csr, init)[0][0].double().cpu().numpy()
        self.boot: Dict[int, np.ndarray] = {}
        if num_boot and sample:
            m = torch.as_tensor(draw(self.reads), device=device).to(dtype)
            counts = ref_em.run_em(csr, init.expand(len(sample), -1).clone(),
                                   mult=m)[0].double().cpu().numpy()
            self.boot = dict(zip(sample, counts))


def judge_bulk(numbers: Numbers, prefix, exp: BulkExpected,
               num_boot: int) -> None:
    meta = read_meta(prefix)
    numbers.see("reads_kept_gap",
                abs(meta["discard_table"]["valid_best_aln"]
                    - exp.valid_best_aln))
    unique, total = read_ambig(prefix)
    numbers.see("alignments_kept_gap",
                int(np.abs(total - exp.total).sum()
                    + np.abs(unique - exp.unique).sum()))
    numbers.see("quant_l1",
                np.abs(read_quant(prefix) - exp.counts).sum() / exp.reads)
    if num_boot:
        names, got = read_infreps(prefix, sorted(exp.boot))
        expected_names = {f"bootstrap.{i}" for i in range(num_boot)}
        numbers.see("replicates_missing", len(expected_names - set(names)))
        worst = 0.0
        for i, want in exp.boot.items():
            worst = max(worst, np.abs(got[i] - want).sum() / exp.reads
                        if i in got else np.inf)
        numbers.see("replicate_l1", worst)


class ScExpected:
    """What a single-cell job of one input must give: the cells, their
    barcodes, and the per-cell EMs' counts."""

    def __init__(self, bam: Path, device, dtype):
        import torch

        rec = load_records(bam)
        kept = filter_records(rec)
        T = len(rec["t_len"])
        rpc = int(rec["reads_per_cell"])
        G = len(rec["sizes"])
        cell_of_read = np.arange(G) // rpc
        self.cells = -(-G // rpc)
        self.barcodes = [b.tobytes().decode() for b in barcode_of(
            np.arange(self.cells), int(rec["barcode_len"]))]
        csr, txp, cell, kept_reads = ref_em.cells_csr(
            kept, cell_of_read, self.cells, T, device, dtype)
        init = torch.as_tensor(kept_reads[cell] / T, device=device).to(
            dtype)[None]
        counts = ref_em.run_em(csr, init)[0][0].double().cpu().numpy()
        self.keys = cell * T + txp
        self.vals = counts
        self.T = T
        self.reads = kept.num_reads


def judge_sc(numbers: Numbers, prefix, exp: ScExpected) -> None:
    rows, cols, vals, num_rows = read_mtx(prefix)
    barcodes = _with(prefix, ".barcodes.txt").read_text().split("\n")[:-1]
    gap = abs(num_rows - exp.cells) + abs(len(barcodes) - exp.cells)
    gap += sum(a != b for a, b in zip(barcodes, exp.barcodes))
    numbers.see("cells_gap", gap)
    numbers.see("matrix_l1", sparse_l1(rows * exp.T + cols, vals, exp.keys,
                                       exp.vals) / exp.reads)


def replicate_sample(seed: int, num_boot: int, k: int) -> List[int]:
    """`k` of the `num_boot` replicates, drawn from the run's seed."""
    if not num_boot:
        return []
    rng = np.random.default_rng([seed % 2**63, 7])
    return sorted(rng.choice(num_boot, size=min(k, num_boot),
                             replace=False).tolist())


def boot_settings(cell):
    """(replicates a job draws, the CLI's `--seed`, the replicates
    checked) of a cell's traffic."""
    cli = cell.traffic["cli"]
    num_boot = int(cli[cli.index("--num-bootstraps") + 1]) if (
        "--num-bootstraps" in cli) else 0
    boot_seed = int(cli[cli.index("--seed") + 1]) if "--seed" in cli else 0
    return num_boot, boot_seed, int(cell.traffic.get("check_replicates", 0))


def drawer(num_boot: int, boot_seed: int, sample: List[int]):
    """`draw(reads)`: the sampled rows of the replicates' multiplicities;
    every input of a cell has as many reads, so one draw serves all."""
    draws: Dict[int, np.ndarray] = {}

    def draw(reads: int) -> np.ndarray:
        if reads not in draws:
            draws[reads] = ref_em.bootstrap_multiplicities(
                reads, num_boot, boot_seed)[sample]
        return draws[reads]

    return draw


def judge(cell, jobs: List[dict], seed: int, device) -> Numbers:
    """`jobs`: for each job of the window `{"input": bam, "out": prefix,
    "ok": bool}`. A job that raised, or whose files do not read, fails
    every number. The reference of each input is worked out once."""
    import torch

    dtype = torch.float64
    numbers = Numbers(dict(cell.traffic["limits"]))
    num_boot, boot_seed, checked = boot_settings(cell)
    sample = replicate_sample(seed, num_boot, checked)
    draw = drawer(num_boot, boot_seed, sample)
    for bam in sorted({str(job["input"]) for job in jobs}):
        if cell.traffic["entry"] == "bulk":
            exp = BulkExpected(Path(bam), num_boot, draw, sample, device,
                               dtype)
        else:
            exp = ScExpected(Path(bam), device, dtype)
        for job in (j for j in jobs if str(j["input"]) == bam):
            try:
                if not job["ok"]:
                    raise RuntimeError("the job raised")
                if cell.traffic["entry"] == "bulk":
                    judge_bulk(numbers, job["out"], exp, num_boot)
                else:
                    judge_sc(numbers, job["out"], exp)
            except (OSError, ValueError, KeyError, IndexError,
                    RuntimeError) as e:
                for name in numbers.limits:
                    numbers.see(name, np.inf)
                numbers.errors.append(f"{job['out']}: {e!r}"[:300])
        del exp
    return numbers
