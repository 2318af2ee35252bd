"""Bulk CLI of the torch port vs the JAX CLI and the pinned goldens.

Simulated BAMs (`util_sim.simulate_bam`, transcript names and lengths
taken from the 7 rows of `tests/golden/bulk/out.quant`, so nothing outside
the repository is read) go through both command lines in this process,
on the CPU in f64 with `--em-impl segsum`. `.quant`, `.ambig_info.tsv` and
`.prob` must be byte-equal between the two packages and to the goldens for
seeds 42/43/44, and the bootstrap replicate values equal. `.meta_info.json`
carries the command line, paths and timings and is not compared.

`--em-impl fast` and `pallas` add in another order and are held to 1e-9
against `segsum`.
"""

import json
from pathlib import Path

import numpy as np
import pyarrow.parquet as pq
import pytest

from oarfish_tpu.cli import main as jax_main
from oarfish_tpu_torch.cli import main as torch_main
from util_sim import simulate_bam
from util_torch import one_torch_thread  # noqa: F401 (autouse fixture)

GOLDEN = Path(__file__).resolve().parent / "golden"
BASE = ["--em-dtype", "float64", "--em-impl", "segsum", "--quiet"]

# tag, reads, seed, extra flags, files compared byte for byte
RUNS = {
    "bulk": (600, 42, ["--write-assignment-probs"],
             [".quant", ".ambig_info.tsv", ".prob"]),
    "bulk_cov": (600, 43, ["--model-coverage", "--bin-width", "100"],
                 [".quant", ".ambig_info.tsv"]),
    "bootstrap": (400, 44, ["--num-bootstraps", "8", "--seed", "7"],
                  [".quant"]),
}


def golden_transcripts():
    rows = [ln.split("\t") for ln in
            (GOLDEN / "bulk" / "out.quant").read_text().splitlines()[1:]]
    return [r[0] for r in rows], [int(r[1]) for r in rows]


def read_counts(path):
    return np.array([float(ln.split("\t")[2])
                     for ln in Path(path).read_text().splitlines()[1:]])


def infreps(path):
    t = pq.read_table(path)
    assert [f.name for f in t.schema] == [
        f"bootstrap.{i}" for i in range(t.num_columns)]
    return np.stack([np.asarray(t[c]) for c in t.column_names])


@pytest.fixture(scope="module")
def runs(tmp_path_factory, request):
    """Every configuration through both CLIs, once per module."""
    # keep the JAX CLI from pointing this process's compilation cache at
    # the home directory
    mp = pytest.MonkeyPatch()
    mp.setenv("OARFISH_JAX_CACHE", "0")
    request.addfinalizer(mp.undo)
    names, lengths = golden_transcripts()
    assert len(names) == 7
    root = tmp_path_factory.mktemp("torch_e2e")
    out = {}
    for tag, (n, seed, extra, _files) in RUNS.items():
        bam = root / f"{tag}.bam"
        simulate_bam(bam, num_reads=n, seed=seed, names=names, lengths=lengths)
        argv = ["--alignments", str(bam), *BASE, *extra]
        assert torch_main(argv + ["-o", str(root / f"{tag}_t"),
                                  "--device", "cpu"]) == 0
        assert jax_main(argv + ["-o", str(root / f"{tag}_j")]) == 0
        out[tag] = (bam, root / f"{tag}_t", root / f"{tag}_j")
    return out


CASES = [(tag, ext) for tag, run in RUNS.items() for ext in run[3]]


@pytest.mark.parametrize("tag,ext", CASES)
def test_outputs_byte_equal_to_jax_cli(runs, tag, ext):
    _, t, j = runs[tag]
    assert Path(str(t) + ext).read_bytes() == Path(str(j) + ext).read_bytes()


@pytest.mark.parametrize("tag,ext", CASES)
def test_outputs_byte_equal_to_golden(runs, tag, ext):
    _, t, _ = runs[tag]
    assert (Path(str(t) + ext).read_bytes()
            == (GOLDEN / tag / f"out{ext}").read_bytes())


def test_bootstrap_values_equal_to_jax_and_golden(runs):
    _, t, j = runs["bootstrap"]
    a, b = infreps(str(t) + ".infreps.pq"), infreps(str(j) + ".infreps.pq")
    assert a.shape == (8, 7)
    np.testing.assert_array_equal(a, b)
    text = "\n".join("\t".join(repr(float(v)) for v in row) for row in a) + "\n"
    assert text == (GOLDEN / "bootstrap" / "infreps.tsv").read_text()


@pytest.mark.parametrize("tag", list(RUNS))
def test_meta_info_names_the_run(runs, tag):
    bam, t, _ = runs[tag]
    meta = json.loads(Path(str(t) + ".meta_info.json").read_text())
    assert meta["alignments"] == str(bam) and meta["output"] == str(t)
    assert meta["num_bootstraps"] == (8 if tag == "bootstrap" else 0)
    assert meta["discard_table"]["valid_best_aln"] > 0


@pytest.mark.parametrize("squarem", [False, True])
@pytest.mark.parametrize("impl", ["fast", "pallas"])
def test_scatter_free_impls_match_segsum_on_cpu(runs, tmp_path, impl, squarem):
    """On the CPU `pallas` runs the sorted gather's plain version (the 600
    reads are too few for a plan, so the layout is the plain CSC one);
    both must agree with segsum to 1e-9."""
    bam, t, _ = runs["bulk_cov"]
    accel = ["--em-accel", "squarem"] if squarem else []
    argv = ["--alignments", str(bam), "--em-dtype", "float64", "--quiet",
            "--model-coverage", "--bin-width", "100", "--device", "cpu",
            *accel]
    ref = t
    if squarem:
        ref = tmp_path / "seg"
        assert torch_main(argv + ["--em-impl", "segsum", "-o", str(ref)]) == 0
    out = tmp_path / impl
    assert torch_main(argv + ["--em-impl", impl, "-o", str(out)]) == 0
    np.testing.assert_allclose(
        read_counts(str(out) + ".quant"), read_counts(str(ref) + ".quant"),
        rtol=1e-9, atol=1e-9)
    assert (Path(str(out) + ".ambig_info.tsv").read_bytes()
            == Path(str(t) + ".ambig_info.tsv").read_bytes())


@pytest.mark.parametrize("impl", ["segsum", "fast", "pallas"])
def test_bootstraps_of_every_impl_match_jax(runs, tmp_path, impl):
    """Same seed, same replicates: the multinomial draw is NumPy's in both
    packages (the scatter-free layouts take it in relabeled read order in
    both)."""
    bam, _, _ = runs["bootstrap"]
    argv = ["--alignments", str(bam), "--em-dtype", "float64", "--quiet",
            "--num-bootstraps", "4", "--seed", "11", "--em-impl", impl]
    assert torch_main(argv + ["-o", str(tmp_path / "t"), "--device", "cpu"]) == 0
    # the JAX package turns `pallas` into `fast` on the CPU
    assert jax_main(argv + ["-o", str(tmp_path / "j")]) == 0
    np.testing.assert_allclose(
        infreps(str(tmp_path / "t") + ".infreps.pq"),
        infreps(str(tmp_path / "j") + ".infreps.pq"), rtol=1e-9, atol=1e-9)


def test_auto_on_cpu_is_segsum_f64(runs, tmp_path):
    bam, t, _ = runs["bulk"]
    out = tmp_path / "auto"
    assert torch_main(["--alignments", str(bam), "-o", str(out), "--quiet",
                       "--device", "cpu"]) == 0
    assert (Path(str(out) + ".quant").read_bytes()
            == Path(str(t) + ".quant").read_bytes())


def test_short_quant_init_and_kde_match_jax(runs, tmp_path):
    bam, t, _ = runs["bulk"]
    sq = tmp_path / "short.tsv"
    names, _ = golden_transcripts()
    sq.write_text("Name\tLength\tEffectiveLength\tTPM\tNumReads\n" + "".join(
        f"{n}\t1000\t800\t1.0\t{10 * (i + 1)}\n" for i, n in enumerate(names)))
    argv = ["--alignments", str(bam), *BASE, "--short-quant", str(sq),
            "--use-kde", "--max-em-iter", "80"]
    assert torch_main(argv + ["-o", str(tmp_path / "t"), "--device", "cpu"]) == 0
    assert jax_main(argv + ["-o", str(tmp_path / "j")]) == 0
    assert (Path(str(tmp_path / "t") + ".quant").read_bytes()
            == Path(str(tmp_path / "j") + ".quant").read_bytes())
