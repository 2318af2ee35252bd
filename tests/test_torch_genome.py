"""Both genome modes of the torch port vs the JAX CLI: genome BAMs
(`--genome-alignments --annotation [--genome-fasta]`) and raw reads
against a genome (`--reads --genome --annotation`, from a FASTA or from
a prebuilt index), on worlds made here from a seed.

The worlds are those of the JAX package's genome-mode tests, rebuilt in
this file: a three-transcript annotation on a 5 kbp chromosome for the
BAM mode (reads along each isoform's exon chain, reads whose soft clip
continues into one isoform's next exon, a multi-mapped read, an unmapped
record), and a two-isoform gene on a 30 kbp chromosome for the read mode
(full-length reads and ONT-like fragments on both strands, some with
unaligned ends). Each case runs with the native projection engine and
with the Python one (`OARFISH_PROJECT_NATIVE`), and with the vectorised
filter and the per-read loop (`OARFISH_BATCH_FILTER`), on the CPU in f64
with `--em-impl segsum`: `.quant`, `.ambig_info.tsv` and `.prob` must be
byte-equal between the two command lines. The projection, the filter,
the genome-to-transcript index and the rescue database are then held
equal between the packages on seeded inputs.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from oarfish_tpu.cli import main as jax_main
from oarfish_tpu_torch.cli import main as torch_main
from util_torch import one_torch_thread  # noqa: F401 (autouse fixture)

BASES = np.frombuffer(b"ACGT", np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")
BASE = ["--em-dtype", "float64", "--em-impl", "segsum", "--quiet",
        "--write-assignment-probs"]
FILES = (".quant", ".ambig_info.tsv", ".prob")

GTF = """\
chr1\ttest\texon\t101\t200\t.\t+\t.\tgene_id "gA"; transcript_id "TxA";
chr1\ttest\texon\t301\t400\t.\t+\t.\tgene_id "gA"; transcript_id "TxA";
chr1\ttest\texon\t501\t600\t.\t+\t.\tgene_id "gA"; transcript_id "TxA";
chr1\ttest\texon\t101\t200\t.\t+\t.\tgene_id "gA"; transcript_id "TxB";
chr1\ttest\texon\t501\t600\t.\t+\t.\tgene_id "gA"; transcript_id "TxB";
chr1\ttest\texon\t1001\t1100\t.\t-\t.\tgene_id "gC"; transcript_id "TxC";
chr1\ttest\texon\t1201\t1300\t.\t-\t.\tgene_id "gC"; transcript_id "TxC";
"""

READS_GTF = (
    'chr1\tt\texon\t2001\t4000\t.\t+\t.\ttranscript_id "TxA";\n'
    'chr1\tt\texon\t6001\t8000\t.\t+\t.\ttranscript_id "TxA";\n'
    'chr1\tt\texon\t10001\t12000\t.\t+\t.\ttranscript_id "TxA";\n'
    'chr1\tt\texon\t2001\t4000\t.\t+\t.\ttranscript_id "TxB";\n'
    'chr1\tt\texon\t10001\t12000\t.\t+\t.\ttranscript_id "TxB";\n'
)


@pytest.fixture(scope="module", autouse=True)
def no_jax_cache():
    mp = pytest.MonkeyPatch()
    mp.setenv("OARFISH_JAX_CACHE", "0")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def bam_world(tmp_path_factory):
    from oarfish_tpu_torch.io import bam

    d = tmp_path_factory.mktemp("genome_bam")
    rng = np.random.default_rng(5)
    genome = BASES[rng.integers(0, 4, 5000)].tobytes().decode()
    (d / "genome.fa").write_text(f">chr1\n{genome}\n")
    (d / "anno.gtf").write_text(GTF)

    def g(a, b):
        return genome[a:b]

    recs = []
    for i in range(12):  # TxA's three exons
        recs.append(dict(name=f"ra{i}", flag=0, ref_id=0, pos=100,
                         cigar="100M100N100M100N100M",
                         seq=g(100, 200) + g(300, 400) + g(500, 600),
                         score=280))
    for i in range(6):  # TxB's skip junction
        recs.append(dict(name=f"rb{i}", flag=0, ref_id=0, pos=100,
                         cigar="100M300N100M", seq=g(100, 200) + g(500, 600),
                         score=190))
    for i in range(4):  # reverse reads on the minus-strand TxC
        recs.append(dict(name=f"rc{i}", flag=0x10, ref_id=0, pos=1000,
                         cigar="100M100N100M",
                         seq=g(1000, 1100) + g(1200, 1300), score=190))
    for i in range(10):
        # exon-1 reads whose soft clip continues into TxA's exon 2, or
        # into TxB's exon (the skip junction): rescue tells them apart
        recs.append(dict(name=f"sa{i}", flag=0, ref_id=0, pos=120,
                         cigar="80M40S", seq=g(120, 200) + g(300, 340),
                         score=100))
        recs.append(dict(name=f"sb{i}", flag=0, ref_id=0, pos=120,
                         cigar="80M40S", seq=g(120, 200) + g(500, 540),
                         score=100))
    for i in range(3):  # two records: exon 1 of gA, and TxC
        recs.append(dict(name=f"m{i}", flag=0, ref_id=0, pos=100,
                         cigar="100M", seq=g(100, 200), score=95))
        recs.append(dict(name=f"m{i}", flag=0x100, ref_id=0, pos=1000,
                         cigar="100M", seq=g(1000, 1100), score=90))
    recs.append(dict(name="u0", flag=0x4, ref_id=-1, pos=-1, cigar="",
                     seq="A" * 50, score=None))
    bam.write_bam(d / "genome.bam", ["chr1"], [5000], recs,
                  program="minimap2")
    return d


def ont_fragment(rng, seq: bytes, sub=0.02) -> bytes:
    span = int(rng.integers(min(1500, len(seq)), len(seq) + 1))
    pos = int(rng.integers(0, len(seq) - span + 1))
    frag = np.frombuffer(seq[pos:pos + span], np.uint8).copy()
    m = rng.random(span) < sub
    frag[m] = BASES[rng.integers(0, 4, int(m.sum()))]
    out = frag.tobytes()
    if rng.random() < 0.3:  # an unaligned 5' end
        out = BASES[rng.integers(0, 4, 25)].tobytes() + out
    if rng.random() < 0.5:
        out = out.translate(COMP)[::-1]
    return out


@pytest.fixture(scope="module")
def reads_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("genome_reads")
    rng = np.random.default_rng(9)
    genome = BASES[rng.integers(0, 4, 30000)].tobytes()
    (d / "anno.gtf").write_text(READS_GTF)
    (d / "genome.fa").write_text(f">chr1\n{genome.decode()}\n")

    def tx(exons):
        return b"".join(genome[s - 1:e] for s, e in exons)

    seq_a = tx([(2001, 4000), (6001, 8000), (10001, 12000)])
    seq_b = tx([(2001, 4000), (10001, 12000)])
    reads = [seq_a] * 10 + [seq_b] * 5
    reads += [ont_fragment(rng, seq_a) for _ in range(20)]
    reads += [ont_fragment(rng, seq_b) for _ in range(12)]
    with open(d / "reads.fa", "wb") as fh:
        for i, r in enumerate(reads):
            fh.write(b">r%d\n" % i + r + b"\n")
    return d


def run_both(d: Path, tag: str, argv, monkeypatch, native="1", batch="1"):
    monkeypatch.setenv("OARFISH_PROJECT_NATIVE", native)
    monkeypatch.setenv("OARFISH_BATCH_FILTER", batch)
    t, j = d / tag / "t" / "q", d / tag / "j" / "q"
    assert torch_main(argv + ["-o", str(t), "--device", "cpu"]) == 0
    assert jax_main(argv + ["-o", str(j)]) == 0
    return t, j


def assert_same_files(t, j):
    for ext in FILES:
        got = Path(str(t) + ext).read_bytes()
        assert got == Path(str(j) + ext).read_bytes(), ext


def quant(prefix) -> dict:
    rows = Path(str(prefix) + ".quant").read_text().splitlines()[1:]
    return {r.split("\t")[0]: float(r.split("\t")[2]) for r in rows}


def bam_argv(d, fasta: bool):
    argv = ["--genome-alignments", str(d / "genome.bam"), "--annotation",
            str(d / "anno.gtf"), "--junc-miss-discount", "0.5", *BASE]
    return argv + (["--genome-fasta", str(d / "genome.fa")] if fasta else [])


@pytest.mark.parametrize("batch", ["1", "0"])
@pytest.mark.parametrize("native", ["1", "0"])
@pytest.mark.parametrize("fasta", [False, True], ids=["no_fasta", "fasta"])
def test_genome_bam_outputs_equal(bam_world, monkeypatch, fasta, native,
                                  batch):
    tag = f"bam_{fasta}_{native}_{batch}"
    t, j = run_both(bam_world, tag, bam_argv(bam_world, fasta), monkeypatch,
                    native, batch)
    assert_same_files(t, j)
    got = quant(t)
    assert set(got) == {"TxA", "TxB", "TxC"}
    assert sum(got.values()) > 30


@pytest.fixture(scope="module")
def genome_index(reads_world):
    """The genome index that a read run with `--index-out` writes, in
    both packages."""
    d = reads_world
    argv = ["--reads", str(d / "reads.fa"), "--genome", str(d / "genome.fa"),
            "--annotation", str(d / "anno.gtf"), "--seq-tech", "ont-cdna",
            *BASE]
    t, j = d / "idx_t.otmi", d / "idx_j.otmi"
    assert torch_main(argv + ["-o", str(d / "idx_run_t"), "--device", "cpu",
                              "--index-out", str(t)]) == 0
    assert jax_main(argv + ["-o", str(d / "idx_run_j"),
                            "--index-out", str(j)]) == 0
    return t, j


def test_genome_index_is_written_alike(genome_index):
    t, j = genome_index
    assert t.read_bytes() == j.read_bytes()


@pytest.mark.parametrize("batch", ["1", "0"])
@pytest.mark.parametrize("native", ["1", "0"])
@pytest.mark.parametrize("source", ["fasta", "index"])
def test_genome_reads_outputs_equal(reads_world, genome_index, monkeypatch,
                                    source, native, batch):
    d = reads_world
    genome = d / "genome.fa" if source == "fasta" else genome_index[0]
    argv = ["--reads", str(d / "reads.fa"), "--genome", str(genome),
            "--annotation", str(d / "anno.gtf"), "--seq-tech", "ont-cdna",
            "--junc-miss-discount", "0.3", *BASE]
    t, j = run_both(d, f"reads_{source}_{native}_{batch}", argv, monkeypatch,
                    native, batch)
    assert_same_files(t, j)
    assert (Path(str(t) + ".annot_junctions.bed").read_bytes()
            == Path(str(j) + ".annot_junctions.bed").read_bytes())
    got = quant(t)
    assert got["TxA"] > got["TxB"] > 5
    if source == "index":
        # the prebuilt index gives what the FASTA gives
        f = d / f"reads_fasta_{native}_{batch}" / "t" / "q"
        if Path(str(f) + ".quant").exists():
            assert_same_files(t, f)


@pytest.mark.parametrize("mode", ["bam", "reads"])
def test_meta_digests_and_discards_equal(bam_world, reads_world, monkeypatch,
                                         mode):
    if mode == "bam":
        d, argv = bam_world, bam_argv(bam_world, True)
    else:
        d = reads_world
        argv = ["--reads", str(d / "reads.fa"), "--genome",
                str(d / "genome.fa"), "--annotation", str(d / "anno.gtf"),
                "--seq-tech", "ont-cdna", *BASE]
    t, j = run_both(d, f"meta_{mode}", argv, monkeypatch)
    mt = json.loads(Path(str(t) + ".meta_info.json").read_text())
    mj = json.loads(Path(str(j) + ".meta_info.json").read_text())
    assert mt["digest"] == mj["digest"]
    assert set(mt["digest"]) == {"transcriptome_digest"}
    assert mt["discard_table"] == mj["discard_table"]
    for key in ("prob_model", "filter_options", "bin_width"):
        assert mt[key] == mj[key], key


def load_both(gtf_path, refnames):
    from oarfish_tpu.genome.annotation import load_transcripts as jload
    from oarfish_tpu.genome.g2t import G2TIndex as JG2T
    from oarfish_tpu_torch.genome.annotation import load_transcripts as tload
    from oarfish_tpu_torch.genome.g2t import G2TIndex as TG2T

    return (TG2T(tload(gtf_path), refnames), JG2T(jload(gtf_path), refnames))


def random_gtf(path, rng, n_chroms=3, genes=12):
    """Multi-exon transcripts on both strands, overlapping isoforms."""
    lines = []
    for c in range(n_chroms):
        for gi in range(genes):
            base = 1 + gi * 4000
            exons = np.sort(rng.choice(np.arange(base, base + 3600, 40),
                                       size=8, replace=False))
            strand = "+" if rng.random() < 0.5 else "-"
            for iso in range(3):
                keep = np.sort(rng.choice(4, size=int(rng.integers(1, 5)),
                                          replace=False))
                for k in keep:
                    s = int(exons[2 * k])
                    e = int(exons[2 * k + 1]) - 1
                    lines.append(f"chr{c}\tt\texon\t{s}\t{e}\t.\t{strand}\t.\t"
                                 f'transcript_id "T{c}_{gi}_{iso}";')
    path.write_text("\n".join(lines) + "\n")
    return [f"chr{c}" for c in range(n_chroms)]


def test_g2t_index_equal(tmp_path):
    rng = np.random.default_rng(21)
    refnames = random_gtf(tmp_path / "r.gtf", rng)
    t, j = load_both(tmp_path / "r.gtf", refnames)
    assert list(t.names) == list(j.names)
    np.testing.assert_array_equal(t.transcript_lengths(),
                                  j.transcript_lengths())
    for a, b in zip(t.models, j.models):
        assert dataclasses.asdict(a).keys() == dataclasses.asdict(b).keys()
        for k, v in dataclasses.asdict(a).items():
            np.testing.assert_array_equal(v, dataclasses.asdict(b)[k], k)
    for _ in range(200):
        c = int(rng.integers(0, len(refnames)))
        s = int(rng.integers(1, 48000))
        e = s + int(rng.integers(1, 3000))
        assert t.candidates(c, s, e) == j.candidates(c, s, e)


def genome_blocks(rng, span=48000):
    """A read's aligned blocks, 1-based inclusive, with the introns
    between them."""
    n = int(rng.integers(1, 5))
    cuts = np.sort(rng.choice(np.arange(1, span, 20), size=2 * n,
                              replace=False))
    blocks = [(int(cuts[2 * i]), int(cuts[2 * i + 1])) for i in range(n)]
    introns = [(blocks[i][1] + 1, blocks[i + 1][0] - 1)
               for i in range(n - 1)]
    return blocks, introns


def rescue_dbs(refnames, rng):
    from oarfish_tpu.genome.rescue import RescueDb as JDb
    from oarfish_tpu_torch.genome.rescue import RescueDb as TDb

    seqs = {n: BASES[rng.integers(0, 4, 50000)].tobytes() for n in refnames}
    return TDb(seqs, refnames), JDb(seqs, refnames)


@pytest.mark.parametrize("tolerance,rescue", [(0, True), (25, False)])
def test_project_blocks_equal(tmp_path, tolerance, rescue):
    from oarfish_tpu.genome.project import project_blocks as jproject
    from oarfish_tpu_torch.genome.project import project_blocks as tproject

    rng = np.random.default_rng(31 + tolerance)
    refnames = random_gtf(tmp_path / "r.gtf", rng)
    t, j = load_both(tmp_path / "r.gtf", refnames)
    tdb, jdb = rescue_dbs(refnames, rng)
    n_records = 0
    for _ in range(300):
        blocks, introns = genome_blocks(rng)
        c = int(rng.integers(0, len(refnames)))
        q = sum(e - s + 1 for s, e in blocks)
        rc, score = bool(rng.random() < 0.5), int(rng.integers(10, 500))
        clips = (BASES[rng.integers(0, 4, int(rng.integers(0, 60)))]
                 .tobytes(), BASES[rng.integers(0, 4, 30)].tobytes())
        got = tproject(c, blocks, introns, q, rc, score, t, 0.4, tolerance,
                       rescue=(tdb, *clips) if rescue else None)
        want = jproject(c, blocks, introns, q, rc, score, j, 0.4, tolerance,
                        rescue=(jdb, *clips) if rescue else None)
        assert ([dataclasses.astuple(r) for r in got]
                == [dataclasses.astuple(r) for r in want])
        n_records += len(got)
    assert n_records > 50


@pytest.mark.parametrize("source", ["similarity", "score", "combined"])
def test_filter_projected_batch_equal(source):
    from oarfish_tpu.config import FilterOpts as JOpts
    from oarfish_tpu.config import ProjProbSource as JSrc
    from oarfish_tpu.genome.project import filter_projected_batch as jfilter
    from oarfish_tpu.host.filters import DiscardTable as JTable
    from oarfish_tpu_torch.config import FilterOpts as TOpts
    from oarfish_tpu_torch.config import ProjProbSource as TSrc
    from oarfish_tpu_torch.genome.project import (
        filter_projected_batch as tfilter,
    )
    from oarfish_tpu_torch.host.filters import DiscardTable as TTable

    rng = np.random.default_rng(41)
    R, T = 400, 50
    per_read = rng.integers(0, 6, R)
    roff = np.zeros(R + 1, np.int64)
    np.cumsum(per_read, out=roff[1:])
    C = int(roff[-1])
    txp_len = rng.integers(500, 3000, T).astype(np.int64)
    tid = rng.integers(0, T, C).astype(np.int64)
    pstart = rng.integers(-20, 400, C).astype(np.int64)
    pend = pstart + rng.integers(50, 2500, C)
    matched = rng.integers(10, 2000, C).astype(np.int64)
    sim = rng.random(C)
    score = rng.integers(0, 2000, C).astype(np.int64)
    is_rev = rng.random(C) < 0.3
    read_len = rng.integers(100, 2500, R).astype(np.int64)
    outs = []
    for opts, table, src, fn in ((TOpts(), TTable(), TSrc(source), tfilter),
                                 (JOpts(), JTable(), JSrc(source), jfilter)):
        res = fn(opts, table, txp_len, roff, tid, pstart, pend, matched, sim,
                 score, is_rev, read_len, 10.0, src)
        outs.append((res, vars(table)))
    (got, t_table), (want, j_table) = outs
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert t_table == j_table
    assert 0 < got[0].sum() < C


def test_rescue_db_equal(tmp_path):
    from oarfish_tpu.genome.rescue import RescueDb as JDb
    from oarfish_tpu.genome.rescue import rescue_clips as jclips
    from oarfish_tpu_torch.genome.rescue import RescueDb as TDb
    from oarfish_tpu_torch.genome.rescue import rescue_clips as tclips

    rng = np.random.default_rng(51)
    refnames = random_gtf(tmp_path / "r.gtf", rng)
    t, j = load_both(tmp_path / "r.gtf", refnames)
    with open(tmp_path / "g.fa", "w") as fh:
        for n in refnames[::-1]:  # not in reference order
            seq = BASES[rng.integers(0, 4, 50000)].tobytes().decode()
            fh.write(f">{n} a description\n{seq.lower()}\n")
    tdb = TDb.from_fasta(tmp_path / "g.fa", refnames + ["chrX"])
    jdb = JDb.from_fasta(tmp_path / "g.fa", refnames + ["chrX"])
    assert tdb.seqs == jdb.seqs and tdb.seqs[-1] is None
    rescued = 0
    for _ in range(300):
        k = int(rng.integers(0, t.num_transcripts))
        m_t, m_j = t.models[k], j.models[k]
        gs = int(rng.integers(m_t.exon_starts[0], m_t.exon_ends[-1] + 1))
        ge = int(rng.integers(gs, m_t.exon_ends[-1] + 1))
        left = tdb.left_context(m_t, gs, 60)
        assert left == jdb.left_context(m_j, gs, 60)
        right = tdb.right_context(m_t, ge, 60)
        assert right == jdb.right_context(m_j, ge, 60)
        # clips that continue the exon chain, or random ones
        cl = left[-40:] if rng.random() < 0.5 else BASES[
            rng.integers(0, 4, 40)].tobytes()
        cr = right[:40] if rng.random() < 0.5 else BASES[
            rng.integers(0, 4, 40)].tobytes()
        got = tclips(tdb, m_t, gs, ge, cl, cr)
        assert got == jclips(jdb, m_j, gs, ge, cl, cr)
        rescued += sum(got)
    assert rescued > 0


def test_native_libraries_come_from_the_build_directory():
    """The mapper and the projection engine are built from the shared
    sources into the port's build directory, never loaded from beside
    the sources."""
    from oarfish_tpu_torch.genome import project_native
    from oarfish_tpu_torch.host import mapper
    from oarfish_tpu_torch.kernels.build import BUILD_DIR

    for module in (mapper, project_native):
        lib = module.get_lib()
        if lib is None:
            pytest.skip("no g++ on this host")
        path = Path(lib._name).resolve()
        assert path.parent == BUILD_DIR.resolve(), path
        assert path.name in ("liboarfish_mapper.so",
                             "liboarfish_project.so")


@pytest.mark.parametrize("mode", ["bam", "reads"])
def test_the_card_is_required_before_any_input_is_read(tmp_path, mode):
    """Without `--device cpu` both drivers fail at once on a host without
    a card: the inputs named here do not exist, and the error is the
    device's, not the missing file's."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    if mode == "bam":
        argv = ["--genome-alignments", str(tmp_path / "none.bam"),
                "--annotation", str(tmp_path / "none.gtf")]
    else:
        argv = ["--reads", str(tmp_path / "none.fa"), "--genome",
                str(tmp_path / "none.fa"), "--annotation",
                str(tmp_path / "none.gtf"), "--seq-tech", "ont-cdna"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_main(argv + ["-o", str(tmp_path / "q")])


def test_chip_smoke_genome_world_runs_alike(tmp_path, monkeypatch):
    """The genome world and the true-alignment BAM that `chip_smoke.py`
    builds, at a small size: a valid name-collated genome BAM whose reads
    in shared exons project onto both isoforms, through both CLIs with
    the same files."""
    from chip_smoke import build_genome_world, simulate_genome_reads

    rng = np.random.default_rng(3)
    sample = rng.choice(40, size=10, replace=False)
    *chroms, isoforms = build_genome_world(tmp_path, rng, 40, 2, sample)
    simulate_genome_reads(tmp_path, rng, isoforms, chroms, 300, threads=2)
    argv = ["--genome-alignments", str(tmp_path / "g.bam"), "--annotation",
            str(tmp_path / "anno.gtf"), "--genome-fasta",
            str(tmp_path / "genome.fa"), *BASE]
    t, j = run_both(tmp_path, "smoke", argv, monkeypatch)
    assert_same_files(t, j)
    meta = json.loads(Path(str(t) + ".meta_info.json").read_text())
    assert meta["discard_table"]["valid_best_aln"] == 300
    counts = quant(t)
    assert abs(sum(counts.values()) - 300) < 1e-6
    # 20 sampled isoforms, both of each gene, share the reads
    assert sum(v > 0 for v in counts.values()) >= 10
