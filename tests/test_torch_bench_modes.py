"""The benchmark's mode lines (`python -m oarfish_tpu_torch.bench --e2e
--boots N`, `--sc`, `--genome`; `oarfish_tpu_torch/bench_modes.py`)
against the JAX system's scripts and package, on the CPU at small sizes.

The inputs: the single-cell BAM and the genome world and reads are the
scripts' bytes for the same arguments and seed (`scripts/sc_e2e_bench.py`,
`scripts/rescue_eval.py`, `scripts/genome_e2e_bench.py`, put on `sys.path`
here only), and `mutate`, which the port computes without a step per base,
gives the scripts' loop's bytes and leaves the generator where it does.
The runs: `--e2e --boots 10` at R = 3,000, T = 500 (batches of 8 and 2)
writes the replicates of the JAX package's `quantify_bulk_alignments_from_bam`
with `num_bootstraps=10` on the same BAM and seed (rtol 1e-9; both f64
segment sums on the CPU, which add in other orders), and a replicate of the
short batch has the bits of its single run; `--sc` writes the JAX
package's `.count.mtx` byte for byte; `--genome` (a child process of the
port's CLI) the JAX CLI's `.quant` byte for byte, and `evaluate` in NumPy
gives `rescue_eval.evaluate`'s numbers.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from oarfish_tpu.cli import main as jax_main
from oarfish_tpu.config import Args as JaxArgs
from oarfish_tpu.config import resolve_filters as jax_filters
from oarfish_tpu_torch import bench as tb
from oarfish_tpu_torch import bench_modes as bm
from oarfish_tpu_torch.config import Args
from oarfish_tpu_torch.ops import bootstrap as boot_ops
from oarfish_tpu_torch.quant import bulk
from util_torch import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"
BOOTS, BOOT_R, BOOT_T = 10, 3000, 500
SC_SHAPE = (200, 10, 300)  # cells, reads a cell, transcripts
GENOME_READS, GENOME_GENES = 500, 20


@pytest.fixture(scope="module", autouse=True)
def no_jax_cache():
    mp = pytest.MonkeyPatch()
    mp.setenv("OARFISH_JAX_CACHE", "0")
    yield
    mp.undo()


@pytest.fixture
def scripts(monkeypatch):
    monkeypatch.syspath_prepend(str(SCRIPTS))


def one_line(capsys) -> dict:
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def infreps(path):
    t = pq.read_table(path)
    assert [f.name for f in t.schema] == [
        f"bootstrap.{i}" for i in range(t.num_columns)]
    return np.stack([np.asarray(t[c]) for c in t.column_names])


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def test_sc_bam_equals_the_script(tmp_path, scripts):
    import sc_e2e_bench

    C, rpc, T = SC_SHAPE
    want_A, _ = sc_e2e_bench.build_sc_bam(tmp_path / "j.bam", C, rpc, T)
    got_A = bm.build_sc_bam(tmp_path / "t.bam", C, rpc, T)
    assert got_A == want_A
    assert ((tmp_path / "t.bam").read_bytes()
            == (tmp_path / "j.bam").read_bytes())
    # kept and reused
    bam, A, gen_s = bm.ensure_sc_bam(tmp_path, C, rpc, T)
    assert A == got_A and gen_s > 0
    assert bm.ensure_sc_bam(tmp_path, C, rpc, T) == (bam, A, 0.0)


@pytest.mark.parametrize("sub,indel,buffered", [
    (0.01, 0.005, False), (0.03, 0.01, True), (0.3, 0.2, False),
    (0.9, 0.9, True), (0.0, 0.0, False)])
def test_mutate_equals_the_script_loop(sub, indel, buffered, scripts):
    """The same bytes and the generator in the same state afterwards,
    its buffered 32-bit half included, over lengths from 0 to 3,000."""
    from rescue_eval import mutate

    g = np.random.default_rng(3)
    for _ in range(40):
        seq = g.choice(np.frombuffer(b"ACGT", np.uint8),
                       size=int(g.integers(0, 3000))).tobytes()
        seed = int(g.integers(1 << 30))
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        if buffered:
            a.integers(0, 1000), b.integers(0, 1000)
        assert bm.mutate(a, seq, sub, indel) == mutate(b, seq, sub, indel)
        assert a.bit_generator.state == b.bit_generator.state
        assert a.integers(4) == b.integers(4) and a.random() == b.random()


def test_genome_world_and_reads_equal_the_script(tmp_path, scripts):
    import genome_e2e_bench
    import rescue_eval

    dirs = []
    for tag, world, simulate in (
            ("j", rescue_eval.build_world, genome_e2e_bench.simulate_reads),
            ("t", bm.build_world, bm.simulate_reads)):
        d = tmp_path / tag
        d.mkdir()
        rng = np.random.default_rng(1)
        iso, e1 = world(d, rng, 12)
        truth = simulate(d, rng, iso, 300)
        dirs.append((d, iso, e1, truth, rng.random()))
    (dj, *want), (dt, *got) = dirs
    assert got == want  # isoforms, E1's length, truth, the next draw
    for name in ("anno.gtf", "genome.fa", "reads.fa", "truth.tsv"):
        assert (dt / name).read_bytes() == (dj / name).read_bytes(), name


# ---------------------------------------------------------------------------
# --e2e --boots
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def boots_run(tmp_path_factory):
    """`--e2e --boots 10 --device cpu` with the segment-sum EM's device
    state and the multiplicities it was given kept aside."""
    work = tmp_path_factory.mktemp("boots")
    kept = {}
    real_run_em, real_replicates = bulk.run_em, boot_ops.run_replicates

    def run_em(data, *args, **kwargs):
        kept["data"] = data
        return real_run_em(data, *args, **kwargs)

    def run_replicates(run, mult, init, *args, **kwargs):
        kept["mult"], kept["init"] = mult, init
        return real_replicates(run, mult, init, *args, **kwargs)

    mp = pytest.MonkeyPatch()
    mp.setattr(bulk, "run_em", run_em)
    mp.setattr(boot_ops, "run_replicates", run_replicates)
    try:
        res = tb.main(["--e2e", "--boots", str(BOOTS), "--device", "cpu",
                       "--reads", str(BOOT_R), "--txps", str(BOOT_T),
                       "--reps", "1", "--work-dir", str(work)])
    finally:
        mp.undo()
    return res.line, work, kept


def test_boots_line_and_replicates_equal_jax(boots_run, tmp_path):
    from oarfish_tpu.quant.bulk import quantify_bulk_alignments_from_bam

    line, work, _ = boots_run
    assert line["metric"] == "e2e_100boot_wall_s"
    assert {"value", "unit", "walls", "replicates_written",
            "per_replicate_s"} <= set(line)  # the JAX script's keys
    assert line["replicates_written"] == BOOTS
    assert len(line["walls"]) == 1 and line["value"] == line["walls"][0]
    assert line["impl"] == "segsum" and "10 bootstraps" in line["unit"]
    assert len(line["bootstrap_iterations"]) == BOOTS
    # the pool of 8 slots takes no more batch m-steps than two fixed
    # batches of 8 and 2, each run to its slowest replicate and its final
    # step, and no fewer than its slowest replicate
    iters = line["bootstrap_iterations"]
    assert (max(iters) + 1 <= line["bootstrap_msteps"]
            <= max(iters[:8]) + max(iters[8:]) + 2)
    assert line["cold"]["bootstrap_iterations"] == line["bootstrap_iterations"]
    bam = work / f"e2e_R{BOOT_R}_T{BOOT_T}_s0.bam"
    args = JaxArgs(alignments=bam, output=tmp_path / "j", threads=4,
                   em_dtype="auto", em_impl="auto", num_bootstraps=BOOTS)
    quantify_bulk_alignments_from_bam(args, jax_filters(args))
    got = infreps(work / "out.infreps.pq")
    want = infreps(tmp_path / "j.infreps.pq")
    assert got.shape == (BOOTS, BOOT_T)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_short_batch_replicate_equals_its_single_run(boots_run):
    """Replicate 8 took the first slot of the pool that came free: the bits
    and iterations of a run of its own multiplicities alone."""
    line, work, kept = boots_run
    defaults = Args()
    m8 = torch.as_tensor(kept["mult"][8], dtype=kept["init"].dtype)
    single, niter = bulk.run_em(kept["data"], kept["init"],
                                defaults.max_em_iter,
                                defaults.convergence_thresh, multiplicity=m8)
    assert int(niter) == line["bootstrap_iterations"][8]
    reps = infreps(work / "out.infreps.pq")
    assert np.array_equal(reps[8], single.double().numpy())
    assert not np.array_equal(reps[8], reps[0])


# ---------------------------------------------------------------------------
# --sc
# ---------------------------------------------------------------------------

def test_sc_line_and_matrix_equal_jax(tmp_path, capsys):
    from oarfish_tpu.quant.single_cell import (
        quantify_single_cell_from_collated_bam,
    )

    C, rpc, T = SC_SHAPE
    res = tb.main(["--sc", "--device", "cpu", "--cells", str(C),
                   "--reads-per-cell", str(rpc), "--txps", str(T),
                   "--work-dir", str(tmp_path)])
    line = one_line(capsys)
    assert line == res.line and line["metric"] == "sc_e2e_cells_per_s"
    assert {"value", "unit", "wall_s", "cells", "alignments", "nnz",
            "peak_rss_gb", "phases_s", "gen_s"} <= set(line)
    assert line["cells"] == C and line["nnz"] > 0
    assert set(line["phases_s"]) == {"sc.parse", "sc.em", "sc.write"}
    bam = tmp_path / f"oarfish_sc_C{C}_r{rpc}_T{T}.bam"
    assert line["alignments"] == json.loads(
        bam.with_suffix(".json").read_text())["A"]
    args = JaxArgs(alignments=bam, output=tmp_path / "j", threads=4,
                   single_cell=True, em_dtype="auto")
    quantify_single_cell_from_collated_bam(args, jax_filters(args))
    for ext in (".count.mtx", ".barcodes.txt", ".features.txt"):
        assert (Path(str(tmp_path / "sc_out") + ext).read_bytes()
                == Path(str(tmp_path / "j") + ext).read_bytes()), ext


# ---------------------------------------------------------------------------
# --genome
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def genome_run(tmp_path_factory):
    work = tmp_path_factory.mktemp("genome")
    res = tb.main(["--genome", "--device", "cpu", "--reads",
                   str(GENOME_READS), "--genes", str(GENOME_GENES),
                   "--work-dir", str(work)])
    return res.line, work


def test_genome_line_and_quant_equal_the_jax_cli(genome_run, tmp_path,
                                                 monkeypatch):
    line, work = genome_run
    assert line["metric"] == "genome_e2e_wall_s"
    assert {"value", "reads", "isoforms", "threads", "reads_per_s",
            "peak_rss_gb", "spearman", "mard", "truth_total",
            "quantified"} <= set(line)  # the JAX script's keys
    assert line["reads"] == line["truth_total"] == GENOME_READS
    assert line["isoforms"] == 2 * GENOME_GENES and line["peak_rss_gb"] > 0
    assert line["spearman"] > 0.9
    monkeypatch.setenv("OARFISH_PLATFORM", "cpu")
    assert jax_main([*bm.genome_argv(work, 4), "-o", str(tmp_path / "j"),
                     "--quiet"]) == 0
    assert ((work / "out.quant").read_bytes()
            == (tmp_path / "j.quant").read_bytes())


def test_child_peak_rss_is_the_childs_own(tmp_path):
    """The child's peak RSS leaves out this process's pages, which a
    process forked from it would count as its own."""
    ballast = np.ones(50_000_000)  # 0.4 GB resident here
    rc, wall, peak = bm.run_child(
        [sys.executable, "-c", "x = b'x' * (200 << 20)"], tmp_path,
        dict(os.environ), tmp_path / "child.log", 120)
    assert rc == 0 and wall > 0
    assert 0.2 < peak < 0.35 < ballast.nbytes / 1e9
    rc, _, _ = bm.run_child([sys.executable, "-c", "raise SystemExit(3)"],
                            tmp_path, dict(os.environ),
                            tmp_path / "child.log", 120)
    assert rc == 3


def test_evaluate_equals_the_script(genome_run, scripts):
    from rescue_eval import evaluate

    line, work = genome_run
    got = bm.evaluate(work / "out.quant", work / "truth.tsv")
    assert got == evaluate(work / "out.quant", work / "truth.tsv")
    assert (got["spearman"], got["mard"]) == (line["spearman"], line["mard"])


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [["--e2e", "--boots", "2"], ["--sc"],
                                  ["--genome"]])
def test_each_mode_raises_without_a_card(argv, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.main([*argv, "--reads", "100", "--txps", "50", "--cells", "10",
                 "--genes", "2", "--work-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())  # it failed before any work


@pytest.mark.parametrize("argv", [["--boots", "3"], ["--sc", "--boots", "3"],
                                  ["--e2e", "--boots", "-1"],
                                  ["--genome", "--quick"], ["--sc", "--e2e"]])
def test_mode_flags_that_do_not_go_together(argv, capsys):
    with pytest.raises(SystemExit):
        tb.parse_args(argv)
    capsys.readouterr()


def test_mode_defaults_are_the_scripts():
    boots = tb.parse_args(["--e2e", "--boots", "100"])
    assert (boots.reads, boots.txps, boots.seed, boots.reps,
            boots.threads) == (2_000_000, 200_000, 0, 2, 4)
    assert tb.parse_args(["--e2e"]).reps == 1  # today's --e2e
    sc = tb.parse_args(["--sc"])
    assert (sc.cells, sc.reads_per_cell, sc.txps) == (100_000, 50, 30_000)
    quick = tb.parse_args(["--sc", "--quick"])
    assert (quick.cells, quick.reads_per_cell, quick.txps) == (2000, 30, 5000)
    genome = tb.parse_args(["--genome"])
    assert (genome.reads, genome.genes, genome.seed, genome.threads) == (
        80_000, 300, 1, 4)


def test_chip_smoke_counts_a_run_with_replicates():
    """`chip_smoke.boots_launches`: the point EM's m-steps, then the batch
    m-steps of the replicates' pool (the span's `msteps`), each a launch
    of the arms too."""
    from chip_smoke import boots_launches

    run = {"em_iters": 10, "bootstrap_iterations": [52] * 7 + [57, 40, 52],
           "bootstrap_msteps": 95}
    got = boots_launches(run, fused=True)
    batched = 95
    assert got == {"sorted_gather": 0, "tile_permute": 2 * (11 + batched),
                   "route_stage": 2 * (11 + batched),
                   "route_middle": 11 + batched,
                   "route_stage_replicates": 2 * batched,
                   "route_middle_replicates": batched,
                   "row_sums": 11 + batched}
    assert boots_launches(run, fused=False)["row_sums"] == 2 * (11 + batched)
