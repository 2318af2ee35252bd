"""Raw-read mode of the torch port (`--reads` against a transcriptome,
`--only-index`) vs the JAX CLI, on sequences made here from a seed.

The transcriptome is a few dozen transcripts in isoform families that
share exons (so reads map to several transcripts), plus single-isoform
genes; the reads are ONT-like fragments on both strands with
substitutions, insertions and deletions, and a few random reads that map
nowhere. Both command lines run in this process on the CPU in f64 with
`--em-impl segsum`: `.quant`, `.ambig_info.tsv` and `.prob` must be
byte-equal, the bootstrap replicates equal, and `meta_info.json`'s digest
fields equal (the rest of it holds paths and timings). The indexes that
`--only-index` writes must be byte-equal, footer included, and so must the
mapper's hits and the migration of a minimap2 `.mmi`.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from oarfish_tpu.cli import main as jax_main
from oarfish_tpu_torch.cli import main as torch_main
from oarfish_tpu_torch.utils import trace
from util_torch import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
BASES = np.frombuffer(b"ACGT", np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")
BASE = ["--em-dtype", "float64", "--em-impl", "segsum", "--quiet"]
SEQ_TECH = ["--seq-tech", "ont-cdna"]
# the card against the CPU: the limit `chip_smoke.py`'s em_full_width uses
# between EM formulations in f32
CUDA_L1_OVER_R = 2e-3


def make_transcriptome(rng):
    """Isoform families (all four exons, exon 2 skipped, exon 3 skipped)
    and single-isoform genes; names in file order."""
    names, seqs = [], []
    for g in range(8):
        exons = [BASES[rng.integers(0, 4, int(rng.integers(150, 400)))]
                 for _ in range(4)]
        for tag, keep in (("a", (0, 1, 2, 3)), ("b", (0, 2, 3)),
                          ("c", (0, 1, 3))):
            names.append(f"G{g}{tag}")
            seqs.append(np.concatenate([exons[i] for i in keep]).tobytes())
    for s in range(6):
        names.append(f"S{s}")
        seqs.append(BASES[rng.integers(0, 4, int(rng.integers(500, 1500)))]
                    .tobytes())
    return names, seqs


def ont_read(rng, seq: bytes, sub=0.03, ins=0.01, dele=0.01) -> bytes:
    """A fragment with substitutions, insertions and deletions, on either
    strand."""
    L = len(seq)
    span = int(rng.integers(min(300, L), L + 1))
    pos = int(rng.integers(0, L - span + 1))
    frag = np.frombuffer(seq[pos:pos + span], np.uint8).copy()
    m = rng.random(span) < sub
    frag[m] = BASES[rng.integers(0, 4, int(m.sum()))]
    frag = frag[rng.random(span) >= dele]
    at = np.nonzero(rng.random(len(frag)) < ins)[0]
    frag = np.insert(frag, at, BASES[rng.integers(0, 4, len(at))])
    out = frag.tobytes()
    if rng.random() < 0.5:
        out = out.translate(COMP)[::-1]
    return out


def write_fasta(path, names, seqs):
    with open(path, "wb") as fh:
        for n, s in zip(names, seqs):
            fh.write(b">" + n.encode() + b"\n" + s + b"\n")


@pytest.fixture(scope="module")
def world(tmp_path_factory, request):
    mp = pytest.MonkeyPatch()
    mp.setenv("OARFISH_JAX_CACHE", "0")
    request.addfinalizer(mp.undo)
    d = tmp_path_factory.mktemp("raw_reads")
    rng = np.random.default_rng(11)
    names, seqs = make_transcriptome(rng)
    write_fasta(d / "txps.fa", names[:-2], seqs[:-2])
    write_fasta(d / "novel.fa", names[-2:], seqs[-2:])
    write_fasta(d / "all.fa", names, seqs)
    weights = rng.dirichlet(np.ones(len(names)) * 0.8)
    picks = rng.choice(len(names), size=400, p=weights)
    reads = [ont_read(rng, seqs[t]) for t in picks]
    reads += [BASES[rng.integers(0, 4, 600)].tobytes() for _ in range(8)]
    write_fasta(d / "reads.fa", [f"r{i}" for i in range(len(reads))], reads)
    return d, names, seqs, reads


def both(d: Path, tag: str, argv):
    """The same command line through the port (on the CPU) and the JAX
    CLI; returns the two output prefixes."""
    t, j = d / f"{tag}_t", d / f"{tag}_j"
    if not Path(str(t) + ".quant").exists():
        assert torch_main(argv + ["-o", str(t), "--device", "cpu"]) == 0
        assert jax_main(argv + ["-o", str(j)]) == 0
    return t, j


def reads_argv(d, *ref):
    return ["--reads", str(d / "reads.fa"), *ref, *SEQ_TECH, *BASE]


RUNS = {
    "annotated": lambda d: reads_argv(d, "--annotated", str(d / "all.fa"))
    + ["--write-assignment-probs"],
    "novel": lambda d: reads_argv(d, "--annotated", str(d / "txps.fa"),
                                  "--novel", str(d / "novel.fa"))
    + ["--write-assignment-probs"],
    "bootstraps": lambda d: reads_argv(d, "--annotated", str(d / "all.fa"))
    + ["--num-bootstraps", "2", "--seed", "3"],
}


@pytest.mark.parametrize("run,ext", [
    ("annotated", ".quant"), ("annotated", ".ambig_info.tsv"),
    ("annotated", ".prob"), ("novel", ".quant"), ("novel", ".prob"),
    ("bootstraps", ".quant"),
])
def test_outputs_are_byte_equal_to_the_jax_cli(world, run, ext):
    d = world[0]
    t, j = both(d, run, RUNS[run](d))
    got = Path(str(t) + ext).read_bytes()
    assert got == Path(str(j) + ext).read_bytes()
    if ext == ".quant":
        counts = [float(ln.split("\t")[2])
                  for ln in got.decode().splitlines()[1:]]
        # most reads map, and the families share them out
        assert sum(counts) > 300 and sum(c > 0 for c in counts) > 10


def test_bootstrap_replicates_equal(world):
    d = world[0]
    t, j = both(d, "bootstraps", RUNS["bootstraps"](d))

    def reps(prefix):
        tab = pq.read_table(str(prefix) + ".infreps.pq")
        return np.stack([np.asarray(tab[c]) for c in tab.column_names])

    got, want = reps(t), reps(j)
    assert got.shape == (2, len(world[1]))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("run", ["annotated", "novel"])
def test_meta_digests_and_discards_equal(world, run):
    d = world[0]
    t, j = both(d, run, RUNS[run](d))
    mt = json.loads(Path(str(t) + ".meta_info.json").read_text())
    mj = json.loads(Path(str(j) + ".meta_info.json").read_text())
    assert mt["digest"] == mj["digest"]
    want = {"annotated": {"annotated_digest"},
            "novel": {"annotated_digest", "novel_digest"}}[run]
    assert set(mt["digest"]) == want
    assert mt["discard_table"] == mj["discard_table"]
    # the random reads map nowhere
    assert mt["discard_table"]["no_mapping"] >= 8


@pytest.fixture(scope="module")
def indexes(world):
    """`--only-index` in both packages over the same FASTA."""
    d = world[0]
    argv = ["--only-index", "--annotated", str(d / "all.fa"), *SEQ_TECH,
            "--quiet"]
    t, j = d / "idx_t.otmi", d / "idx_j.otmi"
    assert torch_main(argv + ["--index-out", str(t)]) == 0
    assert jax_main(argv + ["--index-out", str(j)]) == 0
    return t, j


def test_only_index_writes_the_same_index(indexes):
    from oarfish_tpu_torch.utils.digest import read_digest_footer

    t, j = indexes
    assert t.read_bytes() == j.read_bytes()
    footer = read_digest_footer(str(t))
    assert set(footer) == {"annotated_digest"}


def test_only_index_needs_no_card(world, tmp_path):
    """No `--device`: index building touches no device, so a host
    without a card builds it and CUDA is never initialised (checked in a
    fresh interpreter, where no other test can have touched the card)."""
    d = world[0]
    out = tmp_path / "i.otmi"
    argv = ["--only-index", "--annotated", str(d / "all.fa"),
            "--index-out", str(out), *SEQ_TECH, "--quiet"]
    code = (
        "import sys, torch\n"
        "from oarfish_tpu_torch.cli import main\n"
        f"assert main({argv!r}) == 0\n"
        "print(torch.cuda.is_initialized())\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert out.stat().st_size > 0
    assert r.stdout.strip() == "False"


@pytest.mark.parametrize("which", ["port_index", "jax_index"])
def test_index_runs_equal_the_fasta_run(world, indexes, which):
    """The port on its own index and on the JAX package's writes what its
    FASTA run writes, and so does the JAX CLI on the same index."""
    d = world[0]
    index = indexes[0] if which == "port_index" else indexes[1]
    fasta, _ = both(d, "annotated", RUNS["annotated"](d))
    t, j = both(d, f"index_{which}",
                reads_argv(d, "--index", str(index))
                + ["--write-assignment-probs"])
    for ext in (".quant", ".ambig_info.tsv", ".prob"):
        want = Path(str(fasta) + ext).read_bytes()
        assert Path(str(t) + ext).read_bytes() == want, ext
        assert Path(str(j) + ext).read_bytes() == want, ext
    mt = json.loads(Path(str(t) + ".meta_info.json").read_text())
    mf = json.loads(Path(str(fasta) + ".meta_info.json").read_text())
    assert mt["digest"] == mf["digest"]


@pytest.mark.parametrize("spliced", [False, True])
def test_mapper_hits_equal(world, spliced):
    from oarfish_tpu.host import mapper as jmapper
    from oarfish_tpu_torch.host import mapper as tmapper

    _, names, seqs, reads = world
    hits = []
    for mod in (tmapper, jmapper):
        m = mod.Mapper.from_sequences(names, seqs, threads=2)
        hits.append(m.map_batch(reads, best_n=20, threads=2,
                                spliced=spliced))
    got, want = hits
    fields = ["read_off", "target", "tstart", "tend", "qstart", "qend",
              "score", "is_rc"]
    if spliced:
        fields += ["block_off", "block_s", "block_e"]
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    assert len(got.target) > len(reads) // 2


def test_mmi_migrates_to_the_same_index(world, tmp_path):
    """A sequence-bearing minimap2 `.mmi` (written as the JAX package's
    foreign-index tests write one) parses alike and migrates to the same
    OTMI in both packages."""
    from oarfish_tpu.host import mmi as jmmi
    from oarfish_tpu_torch.host import mmi as tmmi

    _, names, seqs, _ = world
    path = tmp_path / "x.mmi"
    jmmi.write_mmi(path, names, seqs, w=10, k=15)
    a, b = tmmi.parse_mmi(path), jmmi.parse_mmi(path)
    assert (a.names, a.seqs, a.k, a.w, a.flag) == (
        b.names, b.seqs, b.k, b.w, b.flag)
    argv = ["--only-index", "--index", str(path), "--quiet"]
    t, j = tmp_path / "t.otmi", tmp_path / "j.otmi"
    assert torch_main(argv + ["--index-out", str(t)]) == 0
    assert jax_main(argv + ["--index-out", str(j)]) == 0
    assert t.read_bytes() == j.read_bytes()


def test_reads_need_the_card_before_the_index_is_built(world, tmp_path):
    """Without `--device cpu` the run fails at once on a host without a
    card, before the index is built or written."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    d = world[0]
    out = tmp_path / "never.otmi"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_main(reads_argv(d, "--annotated", str(d / "all.fa"))
                   + ["--index-out", str(out), "-o", str(tmp_path / "q")])
    assert not out.exists()


@pytest.mark.cuda
def test_raw_reads_on_the_card_match_the_cpu(world, tmp_path):
    """The CLI with its defaults on the card (auto: pallas at this size,
    f32) against `--device cpu` (segsum, f64); the sorted-gather kernel
    was launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = world[0]
    argv = ["--reads", str(d / "reads.fa"), "--annotated",
            str(d / "all.fa"), *SEQ_TECH, "--quiet"]
    assert torch_main(argv + ["-o", str(tmp_path / "cpu"),
                              "--device", "cpu"]) == 0
    trace.reset("launch.sorted_gather")
    assert torch_main(argv + ["-o", str(tmp_path / "gpu")]) == 0
    assert trace.counter("launch.sorted_gather") > 0

    def counts(prefix):
        return np.array([float(ln.split("\t")[2]) for ln in
                         Path(str(prefix) + ".quant").read_text()
                         .splitlines()[1:]])

    cpu, gpu = counts(tmp_path / "cpu"), counts(tmp_path / "gpu")
    assert np.isfinite(gpu).all()
    assert np.abs(cpu - gpu).sum() / cpu.sum() < CUDA_L1_OVER_R


def test_chip_smoke_raw_read_world_multimaps(tmp_path):
    """The isoform families that `chip_smoke.py` builds, at a small size:
    reads inside shared exons map to several transcripts, so the EM has
    work to do; both CLIs write the same files."""
    from chip_smoke import build_transcriptome, simulate_raw_reads

    rng = np.random.default_rng(4)
    blob, offs, lens = build_transcriptome(tmp_path, rng, 59)
    assert len(lens) == 59 and offs[-1] == len(blob)
    # the last family is cut to the two isoforms that fit
    assert blob[offs[57]:offs[58]].tobytes() in (tmp_path / "txps.fa") \
        .read_bytes()
    truth = simulate_raw_reads(tmp_path, rng, blob, offs, lens, 400, 20)
    assert truth.sum() == 400
    t, j = both(tmp_path, "smoke",
                ["--reads", str(tmp_path / "reads.fa"), "--annotated",
                 str(tmp_path / "txps.fa"), *SEQ_TECH, *BASE])
    for ext in (".quant", ".ambig_info.tsv"):
        assert (Path(str(t) + ext).read_bytes()
                == Path(str(j) + ext).read_bytes()), ext
    # per transcript: unique reads, ambiguous reads, total
    ambig = np.loadtxt(str(t) + ".ambig_info.tsv", skiprows=1)
    unique, shared = ambig[:, 0].sum(), ambig[:, 1].sum()
    meta = json.loads(Path(str(t) + ".meta_info.json").read_text())
    kept = meta["discard_table"]["valid_best_aln"]
    assert kept > 380
    # some reads are ambiguous, each counted at two transcripts or more
    assert kept - unique > 0.05 * kept, (unique, kept)
    assert shared >= 2 * (kept - unique), (shared, unique, kept)
