"""Single-cell mode of the torch port vs the JAX CLI and the pinned golden.

The golden's own run (`tests/test_golden.py::test_golden_single_cell`: 300
reads, seed 45, barcodes `BC00`-`BC05`, f64) is simulated with the
transcript names and lengths of `tests/golden/bulk/out.quant`, so nothing
outside the repository is read. It goes through both command lines in
this process, on the CPU, plain and with `--model-coverage`, under
`OARFISH_SC_IMPL=segsum` and `=dense`. Each run has its own directory and
the same relative paths, so `.meta_info.json` (which holds no timing in
single-cell mode) is compared byte for byte too. `.count.mtx`,
`.features.txt`, `.barcodes.txt` and `.meta_info.json` must be
byte-equal to the JAX CLI's, and the plain `segsum` run (what `auto` takes
on the CPU) byte-equal to `tests/golden/single_cell`, its meta masked as
the golden test masks it.
"""

import json
import logging
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from oarfish_tpu.cli import main as jax_main
from oarfish_tpu_torch.cli import main as torch_main
from oarfish_tpu_torch.quant import single_cell as tsc
from util_sim import simulate_bam
from util_torch import one_torch_thread  # noqa: F401 (autouse fixture)

GOLDEN = Path(__file__).resolve().parent / "golden"
FILES = [".count.mtx", ".features.txt", ".barcodes.txt", ".meta_info.json"]
RUNS = {  # tag -> (OARFISH_SC_IMPL, extra flags)
    "segsum": ("segsum", []),
    "dense": ("dense", []),
    "segsum_cov": ("segsum", ["--model-coverage"]),
    "dense_cov": ("dense", ["--model-coverage"]),
}
ARGV = ["--alignments", "../sc.bam", "-o", "sc", "--single-cell",
        "--em-dtype", "float64", "--quiet"]


def golden_transcripts():
    rows = [ln.split("\t") for ln in
            (GOLDEN / "bulk" / "out.quant").read_text().splitlines()[1:]]
    return [r[0] for r in rows], [int(r[1]) for r in rows]


def mask_meta(text: str) -> bytes:
    """`tests/test_golden.py::_mask_meta`: the timing block zeroed, paths
    cut to their names."""
    d = json.loads(text)
    d["alignment_time"] = {"comment": "masked", "human_time": "0s",
                           "seconds": 0.0}
    for key in ("alignments", "output"):
        if d.get(key):
            d[key] = Path(d[key]).name
    return (json.dumps(d, indent=2) + "\n").encode()


def read_mtx(path: Path):
    lines = path.read_text().splitlines()
    rows, cols, _ = map(int, lines[1].split())
    m = np.zeros((rows, cols))
    for ln in lines[2:]:
        r, c, v = ln.split()
        m[int(r) - 1, int(c) - 1] = float(v)
    return m


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every configuration through both CLIs, once per module."""
    mp = pytest.MonkeyPatch()
    # keep the JAX CLI from pointing this process's compilation cache at
    # the home directory
    mp.setenv("OARFISH_JAX_CACHE", "0")
    root = tmp_path_factory.mktemp("torch_sc")
    names, lengths = golden_transcripts()
    simulate_bam(root / "sc.bam", num_reads=300, seed=45,
                 barcodes=[f"BC{i:02d}" for i in range(6)],
                 names=names, lengths=lengths)
    cwd = os.getcwd()
    out = {}
    try:
        for tag, (impl, extra) in RUNS.items():
            mp.setenv("OARFISH_SC_IMPL", impl)
            for side, main, more in (("t", torch_main, ["--device", "cpu"]),
                                     ("j", jax_main, [])):
                d = root / f"{side}_{tag}"
                d.mkdir()
                os.chdir(d)
                assert main(ARGV + extra + more) == 0
            out[tag] = (root / f"t_{tag}" / "sc", root / f"j_{tag}" / "sc")
    finally:
        os.chdir(cwd)
        mp.undo()
    return out


@pytest.mark.parametrize("ext", FILES)
@pytest.mark.parametrize("tag", list(RUNS))
def test_outputs_byte_equal_to_jax_cli(runs, tag, ext):
    t, j = runs[tag]
    assert Path(str(t) + ext).read_bytes() == Path(str(j) + ext).read_bytes()


@pytest.mark.parametrize("ext", FILES)
def test_outputs_byte_equal_to_golden(runs, ext):
    t, _ = runs["segsum"]
    got = Path(str(t) + ext).read_bytes()
    if ext == ".meta_info.json":
        got = mask_meta(got.decode())
    assert got == (GOLDEN / "single_cell" / f"out{ext}").read_bytes()


@pytest.mark.parametrize("cov", ["", "_cov"])
def test_dense_and_segsum_agree(runs, cov):
    """The two formulations are one EM: the same matrix to f32 output
    precision, and the mass of every cell is its reads."""
    a = read_mtx(Path(str(runs["segsum" + cov][0]) + ".count.mtx"))
    b = read_mtx(Path(str(runs["dense" + cov][0]) + ".count.mtx"))
    assert a.shape == (6, 7)
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert (a.sum(axis=1) > 0).all()


def test_auto_impl_follows_the_device(monkeypatch):
    monkeypatch.delenv("OARFISH_SC_IMPL", raising=False)
    assert tsc.sc_impl(torch.device("cpu")) == "segsum"
    assert tsc.sc_impl(torch.device("cuda", 0)) == "dense"
    monkeypatch.setenv("OARFISH_SC_IMPL", "dense")
    assert tsc.sc_impl(torch.device("cpu")) == "dense"
    monkeypatch.setenv("OARFISH_SC_IMPL", "sparse")
    with pytest.raises(ValueError, match="OARFISH_SC_IMPL"):
        tsc.sc_impl(torch.device("cpu"))


def test_num_shards_raises_naming_the_queue_item(runs, monkeypatch):
    """`--num-shards 2`, which raised until the sharded EMs were ported,
    runs: on the CPU (one device) and with the cells of each bucket spread
    over two devices (`[cpu, cpu]`), both byte-equal to the single-device
    run, dense and segment sums alike."""
    root = runs["segsum"][0].parent.parent
    one = tsc.cell_devices
    for impl in ("segsum", "dense"):
        monkeypatch.setenv("OARFISH_SC_IMPL", impl)
        for tag, devices in (("one", one),
                             ("two", lambda args, device: [device] * 2)):
            monkeypatch.setattr(tsc, "cell_devices", devices)
            d = root / f"shards_{impl}_{tag}"
            d.mkdir()
            monkeypatch.chdir(d)
            assert torch_main(ARGV + ["--num-shards", "2", "--device",
                                      "cpu"]) == 0
            for ext in (".count.mtx", ".barcodes.txt", ".features.txt"):
                assert (Path("sc" + ext).read_bytes() == Path(
                    str(runs[impl][0]) + ext).read_bytes()), (impl, tag, ext)


def test_single_cell_without_a_card_raises(tmp_path):
    """No quiet move to the CPU: the default device is the card, and its
    absence is an error before the input is opened."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_main(["--alignments", str(tmp_path / "missing.bam"),
                    "-o", str(tmp_path / "sc"), "--single-cell"])


def test_streaming_path_matches_native(runs, tmp_path, monkeypatch):
    """Without the native decoder the records stream through
    `iter_barcode_groups` / `build_cell_store`: the same files."""
    from oarfish_tpu_torch.host import native

    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setenv("OARFISH_SC_IMPL", "segsum")
    d = tmp_path / "stream"
    d.mkdir()
    monkeypatch.chdir(d)
    bam = runs["segsum"][0].parent.parent / "sc.bam"
    assert torch_main(["--alignments", str(bam), "-o", "sc", "--single-cell",
                       "--em-dtype", "float64", "--quiet",
                       "--device", "cpu"]) == 0
    for ext in (".count.mtx", ".barcodes.txt"):
        assert ((d / f"sc{ext}").read_bytes()
                == Path(str(runs["segsum"][0]) + ext).read_bytes())


BUCKET = re.compile(r"sc bucket \((\d+), (\d+), (\d+)\): (\d+) cells, "
                    r"(\w+), (\d+) sub-batches of at most (\d+)")


@pytest.fixture(scope="module")
def skewed_bam(tmp_path_factory):
    """A CB-collated BAM whose cells hold 2 to 120 reads of 1 to 3
    alignments over the golden's transcripts, so that they fall into
    several size buckets."""
    from oarfish_tpu.io import bam

    names, lengths = golden_transcripts()
    rng = np.random.default_rng(7)
    records, rid = [], 0
    for c, n_reads in enumerate([2, 3, 5, 9, 17, 30, 60, 120, 4, 40]):
        for _ in range(n_reads):
            score = int(rng.integers(200, 400))
            for k in range(int(rng.integers(1, 4))):
                t = int(rng.integers(0, len(names)))
                span = min(150, lengths[t])
                records.append(dict(
                    name=f"read{rid}", flag=bam.FLAG_SECONDARY if k else 0,
                    ref_id=t, pos=int(rng.integers(0, lengths[t] - span + 1)),
                    cigar=f"{span}M", seq="" if k else "A" * span,
                    score=score - 3 * k, barcode=f"CELL{c:02d}"))
            rid += 1
    path = tmp_path_factory.mktemp("skewed") / "sc.bam"
    bam.write_bam(path, names, lengths, records)
    return path


def run_logged(bam, tmp_path, monkeypatch, caplog, env, main=torch_main,
               more=("--device", "cpu")):
    """`bam` through a CLI under `env`, with the relative paths of the
    `runs` fixture; (output prefix, the port's bucket lines as (cells,
    impl, sub-batches, cells at most))."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    d = tmp_path / main.__module__.split(".")[0]
    d.mkdir(parents=True)
    if not (d.parent / "sc.bam").exists():
        (d.parent / "sc.bam").symlink_to(bam)
    monkeypatch.chdir(d)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="oarfish_tpu_torch"):
        assert main(ARGV + list(more)) == 0
    buckets = [(int(m[4]), m[5], int(m[6]), int(m[7]))
               for m in (BUCKET.search(r.getMessage()) for r in caplog.records)
               if m]
    return d / "sc", buckets


def test_dense_budget_sets_the_sub_batches(runs, tmp_path, monkeypatch,
                                           caplog):
    """`OARFISH_SC_DENSE_BUDGET_MB=0` leaves one cell to a sub-batch: the
    golden's bucket of 6 cells runs as 6 sub-batches, and the files are
    the default dense run's (and so the JAX CLI's)."""
    bam = runs["segsum"][0].parent.parent / "sc.bam"
    out, buckets = run_logged(bam, tmp_path, monkeypatch, caplog, {
        "OARFISH_SC_IMPL": "dense", "OARFISH_SC_DENSE_BUDGET_MB": "0"})
    assert buckets == [(6, "dense", 6, 1)], buckets
    for ext in FILES:
        assert (Path(str(out) + ext).read_bytes()
                == Path(str(runs["dense"][0]) + ext).read_bytes())


@pytest.mark.parametrize("impl", ["segsum", "dense"])
def test_max_buckets_matches_the_jax_cli(skewed_bam, tmp_path, monkeypatch,
                                         caplog, impl):
    """Cells of many sizes fill more than 2 buckets; under
    `OARFISH_SC_MAX_BUCKETS=2` the port coarsens them into 2, and both
    CLIs write the same files."""
    monkeypatch.setenv("OARFISH_JAX_CACHE", "0")
    _, default = run_logged(skewed_bam, tmp_path / "default", monkeypatch,
                            caplog, {"OARFISH_SC_IMPL": impl})
    assert len(default) > 2, default
    env = {"OARFISH_SC_MAX_BUCKETS": "2"}
    out, buckets = run_logged(skewed_bam, tmp_path, monkeypatch, caplog, env)
    assert len(buckets) == 2 and {b[1] for b in buckets} == {impl}, buckets
    assert sum(b[0] for b in buckets) == sum(b[0] for b in default)
    want, _ = run_logged(skewed_bam, tmp_path, monkeypatch, caplog, env,
                         main=jax_main, more=())
    for ext in FILES:
        assert (Path(str(out) + ext).read_bytes()
                == Path(str(want) + ext).read_bytes())


@pytest.mark.cuda
@pytest.mark.parametrize("cov", [[], ["--model-coverage"]])
def test_dense_on_the_card_matches_segsum_on_the_card(runs, tmp_path,
                                                      monkeypatch, cov):
    """On the card `auto` takes `dense`; f32 against `segsum` on the card:
    the same matrix within L1 / reads < 1e-6 (the limit of `chip_smoke.py`,
    between sound runs and a dense run with TF32 products), and against
    the CPU's f64 segsum run within 2e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bam = runs["segsum"][0].parent.parent / "sc.bam"
    mats = {}
    for impl in ("auto", "segsum"):
        monkeypatch.setenv("OARFISH_SC_IMPL", impl)
        out = tmp_path / impl / "sc"
        assert torch_main(["--alignments", str(bam), "-o", str(out),
                           "--single-cell", "--quiet", *cov]) == 0
        mats[impl] = read_mtx(Path(str(out) + ".count.mtx"))
    reads = mats["segsum"].sum()
    assert abs(mats["auto"].sum() - reads) / reads < 1e-5
    assert np.abs(mats["auto"] - mats["segsum"]).sum() / reads < 1e-6
    cpu = read_mtx(Path(str(runs["segsum_cov" if cov else "segsum"][0])
                        + ".count.mtx"))
    assert np.abs(mats["auto"] - cpu).sum() / reads < 2e-3
