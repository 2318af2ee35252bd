"""Several processes of the torch port's CLI under one gloo process group
(`--device cpu`), against the JAX CLI's single-process `--em-impl segsum`
run on the same input (in this process, f64), as `tests/test_multiprocess.py`
holds the JAX package's own multi-process runs: counts at rtol 1e-6 /
atol 1e-6; the aux counts (`.ambig_info.tsv`) and the discard table equal.

* 2 processes with the flags, 2 with the environment variables in their
  place (`OARFISH_COORDINATOR`, `OARFISH_NUM_PROCESSES`,
  `OARFISH_PROCESS_ID`), and 4 processes: every process packs the same
  BAM, process 0 alone writes.
* `{proc}` ingest: each of 2 processes packs its half of the reads
  (`shard.{proc}.bam`) with the coverage model, 2 bootstrap replicates and
  `--write-assignment-probs`; against the merged run, plus the
  replicates' mass and the `part{i}.prob` files, whose reads together are
  the merged run's.
* `{proc}` raw reads: each process maps its own FASTA.
* single cell under 2 processes: each runs it whole, as the JAX CLI does.

Each process is a fresh interpreter (about 3 s to import torch); the group
meets at a free local port.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from oarfish_tpu.cli import main as jax_main
from test_torch_raw_reads import make_transcriptome, ont_read, write_fasta
from util_sim import simulate_bam
from util_torch import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
F64 = ["--em-dtype", "float64", "--device", "cpu"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_group(argv_of, n: int, env_of=None, timeout=300):
    """Start `n` port CLIs (`argv_of(i)`, `env_of(i)` added to the
    environment) together and wait for all; returns their stderr."""
    procs = []
    for i in range(n):
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        env.update(env_of(i) if env_of else {})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "oarfish_tpu_torch", *argv_of(i)],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = [p.communicate(timeout=timeout) for p in procs]
    for i, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i}:\n{err[-3000:]}"
    return [err for _, err in outs]


def flags(port, n, i):
    return ["--coordinator", f"localhost:{port}", "--num-processes", str(n),
            "--process-id", str(i)]


def counts(path):
    rows = [ln.split("\t") for ln in Path(path).read_text().splitlines()[1:]]
    return {r[0]: float(r[2]) for r in rows}


def assert_counts_close(got_path, want_path):
    got, want = counts(got_path), counts(want_path)
    assert set(got) == set(want)
    keys = sorted(want)
    np.testing.assert_allclose([got[k] for k in keys],
                               [want[k] for k in keys], rtol=1e-6, atol=1e-6)


def jax_single(tmp_path, monkeypatch, argv, out):
    monkeypatch.setenv("OARFISH_JAX_CACHE", "0")
    assert jax_main(argv + ["-o", str(out), "--em-dtype", "float64",
                            "--em-impl", "segsum", "--quiet"]) == 0


@pytest.mark.parametrize("n,how", [(2, "flags"), (2, "environment"),
                                   (4, "flags")])
def test_processes_match_the_single_process_run(tmp_path, monkeypatch, n,
                                                how):
    bam = tmp_path / "sim.bam"
    simulate_bam(bam, num_reads=400, seed=33 + n)
    port = free_port()

    def argv_of(i):
        argv = ["--alignments", str(bam), "-o", str(tmp_path / f"mp{i}"),
                *F64]
        return argv + (flags(port, n, i) if how == "flags" else [])

    def env_of(i):
        if how == "flags":
            return {}
        return {"OARFISH_COORDINATOR": f"localhost:{port}",
                "OARFISH_NUM_PROCESSES": str(n),
                "OARFISH_PROCESS_ID": str(i)}

    errs = run_group(argv_of, n, env_of)
    for i, err in enumerate(errs):
        assert f"distributed: process {i}/{n} (gloo" in err
    assert any(f"multi-process EM ({n} processes, {n} shards)" in e
               for e in errs)
    assert (tmp_path / "mp0.quant").exists()
    for i in range(1, n):
        assert not list(tmp_path.glob(f"mp{i}*")), i
    jax_single(tmp_path, monkeypatch, ["--alignments", str(bam)],
               tmp_path / "single")
    assert_counts_close(tmp_path / "mp0.quant", tmp_path / "single.quant")
    assert ((tmp_path / "mp0.ambig_info.tsv").read_text()
            == (tmp_path / "single.ambig_info.tsv").read_text())
    meta = json.loads((tmp_path / "mp0.meta_info.json").read_text())
    want = json.loads((tmp_path / "single.meta_info.json").read_text())
    assert meta["discard_table"] == want["discard_table"]


def prob_reads(path):
    """The read names of a `.prob` file: a line "T<tab>R", T transcript
    names, then one line per read."""
    lines = Path(path).read_text().splitlines()
    n_txps, n_reads = (int(x) for x in lines[0].split("\t"))
    reads = [ln.split("\t")[0] for ln in lines[1 + n_txps:]]
    assert len(reads) == n_reads
    return sorted(reads)


def test_sharded_ingest_matches_the_merged_run(tmp_path, monkeypatch):
    simulate_bam(tmp_path / "merged.bam", num_reads=360, seed=77)
    for p in range(2):
        simulate_bam(tmp_path / f"shard.{p}.bam", num_reads=360, seed=77,
                     keep=lambda r, p=p: r % 2 == p)
    port = free_port()
    base = ["--model-coverage", "--write-assignment-probs"]
    errs = run_group(
        lambda i: ["--alignments", str(tmp_path / "shard.{proc}.bam"),
                   "-o", str(tmp_path / f"sh{i}"), *F64, *base,
                   "--num-bootstraps", "2", *flags(port, 2, i)], 2)
    assert any("sharded ingest: 180/360 local reads" in e for e in errs)
    jax_single(tmp_path, monkeypatch,
               ["--alignments", str(tmp_path / "merged.bam"), *base],
               tmp_path / "single")
    assert_counts_close(tmp_path / "sh0.quant", tmp_path / "single.quant")
    assert ((tmp_path / "sh0.ambig_info.tsv").read_text()
            == (tmp_path / "single.ambig_info.tsv").read_text())
    meta = json.loads((tmp_path / "sh0.meta_info.json").read_text())
    want = json.loads((tmp_path / "single.meta_info.json").read_text())
    assert meta["discard_table"] == want["discard_table"]
    assert meta["num_bootstraps"] == 2
    assert not (tmp_path / "sh1.quant").exists()

    import pyarrow.parquet as pq

    reps = pq.read_table(tmp_path / "sh0.infreps.pq")
    assert reps.num_columns == 2
    mass = sum(counts(tmp_path / "single.quant").values())
    for col in reps.column_names:
        s = float(np.asarray(reps[col]).sum())
        assert abs(s - mass) < 0.02 * mass, (col, s, mass)
    parts = [prob_reads(tmp_path / f"sh{i}.part{i}.prob") for i in range(2)]
    assert not set(parts[0]) & set(parts[1])
    assert sorted(parts[0] + parts[1]) == prob_reads(
        tmp_path / "single.prob")


def test_sharded_raw_reads_match_the_single_process_run(tmp_path,
                                                        monkeypatch):
    from oarfish_tpu_torch.host import mapper

    if not mapper.available():
        pytest.skip("native mapper not built")
    rng = np.random.default_rng(9)
    names, seqs = make_transcriptome(rng)
    write_fasta(tmp_path / "ref.fa", names, seqs)
    shards = [open(tmp_path / f"reads.{p}.fa", "wb") for p in range(2)]
    whole = open(tmp_path / "reads.fa", "wb")
    for r in range(160):
        rec = b">read%d\n%s\n" % (r, ont_read(rng, seqs[r % len(seqs)]))
        shards[r % 2].write(rec)
        whole.write(rec)
    for fh in (*shards, whole):
        fh.close()
    port = free_port()
    ref = ["--annotated", str(tmp_path / "ref.fa"), "--seq-tech", "ont-cdna"]
    errs = run_group(
        lambda i: ["--reads", str(tmp_path / "reads.{proc}.fa"),
                   "-o", str(tmp_path / f"rr{i}"), *F64, *ref,
                   *flags(port, 2, i)], 2)
    assert any("sharded ingest" in e for e in errs)
    jax_single(tmp_path, monkeypatch,
               ["--reads", str(tmp_path / "reads.fa"), *ref],
               tmp_path / "single")
    assert_counts_close(tmp_path / "rr0.quant", tmp_path / "single.quant")
    assert not (tmp_path / "rr1.quant").exists()


def test_single_cell_under_two_processes_runs_whole_in_each(tmp_path,
                                                            monkeypatch):
    """Single-cell mode takes no collective, in the JAX CLI as here: each
    of two processes quantifies every cell and writes its own output, the
    JAX CLI's bytes."""
    simulate_bam(tmp_path / "sc.bam", num_reads=200, seed=45,
                 barcodes=[f"BC{i}" for i in range(4)],
                 names=[f"t{i}" for i in range(6)],
                 lengths=[1000 + 100 * i for i in range(6)])
    port = free_port()
    argv = ["--alignments", str(tmp_path / "sc.bam"), "--single-cell",
            "--em-dtype", "float64"]
    run_group(lambda i: [*argv, "-o", str(tmp_path / f"sc{i}"), "--device",
                         "cpu", *flags(port, 2, i)], 2)
    monkeypatch.setenv("OARFISH_JAX_CACHE", "0")
    assert jax_main(argv + ["-o", str(tmp_path / "j"), "--quiet"]) == 0
    for ext in (".count.mtx", ".features.txt", ".barcodes.txt"):
        want = (tmp_path / f"j{ext}").read_bytes()
        for i in range(2):
            assert (tmp_path / f"sc{i}{ext}").read_bytes() == want, (i, ext)


def test_chip_smoke_halves_split_the_reads(tmp_path):
    """The two BAM halves that `chip_smoke.py` writes beside its BAM, for
    two processes, hold together the BAM's reads and alignments, split on
    read boundaries; the BAM is the one written alone."""
    from chip_smoke import build_e2e_bam
    from oarfish_tpu_torch.config import Args, resolve_filters
    from oarfish_tpu_torch.host.packer import pack_bam_fast

    whole = tmp_path / "whole.bam"
    halves = [tmp_path / f"half.{i}.bam" for i in range(2)]
    kw = dict(seed=4, chunk_reads=500, threads=2)
    n = build_e2e_bam(whole, 3000, 50, **kw)
    again = tmp_path / "again.bam"
    assert build_e2e_bam(again, 3000, 50, parts=halves, **kw) == n
    assert again.read_bytes() == whole.read_bytes()
    opts = resolve_filters(Args())

    def pack(path):
        return pack_bam_fast(path, opts, bin_width=100, threads=1)[1]

    w, parts = pack(whole), [pack(h) for h in halves]
    assert [p.num_reads for p in parts] == [1500, 1500]
    assert sum(p.num_alignments for p in parts) == w.num_alignments
    np.testing.assert_array_equal(
        np.sort(np.concatenate([p.txp_id for p in parts])), np.sort(w.txp_id))
