"""`--profile-dir`: a torch.profiler trace of a whole CLI run.

The port's CLI takes every option of the JAX CLI, plus `--device`. With
`--profile-dir D` the run is traced from end to end and leaves one gzipped
Chrome trace per process in `D`, written also when the run raises; its
outputs are the bytes of the same run without the option and of the JAX
CLI's run with its own `--profile-dir`. On the CPU the trace holds the
host's operators alone.
"""

import gzip
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity

from oarfish_tpu.cli import build_parser as jax_parser
from oarfish_tpu.cli import main as jax_main
from oarfish_tpu_torch.cli import build_parser, main as torch_main
from oarfish_tpu_torch.cli import profile_activities, to_args
from test_torch_bulk_e2e import BASE, RUNS, golden_transcripts
from test_torch_package import quant_counts, run_two_processes
from util_sim import simulate_bam
from util_torch import one_torch_thread  # noqa: F401 (autouse fixture)

READS, SEED, EXTRA, FILES = RUNS["bulk"]


def option_strings(parser):
    return {s for action in parser._actions for s in action.option_strings}


def traces(directory: Path) -> list:
    return sorted(directory.glob("*.pt.trace.json.gz"))


def trace_events(path: Path) -> list:
    with gzip.open(path, "rt") as fh:
        return json.load(fh)["traceEvents"]


def test_the_two_clis_differ_only_by_device():
    """Guards against drift: an option added to one CLI and not the other
    fails here."""
    ours, theirs = option_strings(build_parser()), option_strings(jax_parser())
    assert ours - theirs == {"--device"}
    assert theirs - ours == set()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, request):
    """`tests/test_torch_bulk_e2e.py`'s `bulk` configuration through the
    port without and with `--profile-dir`, and through the JAX CLI with
    its own."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OARFISH_JAX_CACHE", "0")
    request.addfinalizer(mp.undo)
    names, lengths = golden_transcripts()
    root = tmp_path_factory.mktemp("profile_dir")
    bam = root / "bulk.bam"
    simulate_bam(bam, num_reads=READS, seed=SEED, names=names,
                 lengths=lengths)
    argv = ["--alignments", str(bam), *BASE, *EXTRA]
    port = argv + ["--device", "cpu"]
    assert torch_main(port + ["-o", str(root / "plain")]) == 0
    assert torch_main(port + ["-o", str(root / "traced"), "--profile-dir",
                              str(root / "trace_t")]) == 0
    assert jax_main(argv + ["-o", str(root / "jax"), "--profile-dir",
                            str(root / "trace_j")]) == 0
    return root


def test_profiled_run_leaves_one_trace(runs):
    found = traces(runs / "trace_t")
    assert len(found) == 1, found
    assert list((runs / "trace_t").iterdir()) == found
    assert trace_events(found[0])
    # the JAX CLI's trace is its profiler's own layout
    assert any(p.is_file() for p in (runs / "trace_j").rglob("*"))


@pytest.mark.parametrize("ext", FILES)
def test_profiled_outputs_byte_equal(runs, ext):
    traced = (runs / f"traced{ext}").read_bytes()
    assert traced == (runs / f"plain{ext}").read_bytes()
    assert traced == (runs / f"jax{ext}").read_bytes()


def test_profiled_trace_holds_the_spans(runs, tmp_path):
    """The port's spans (`utils/trace.py`) are ranges on the profiler's
    host timeline: a traced run with bootstrap replicates holds its
    ingest, its draw and its batches as CPU events, also under
    `--quiet`."""
    assert torch_main(["--alignments", str(runs / "bulk.bam"), *BASE,
                       "--device", "cpu", "--num-bootstraps", "2", "-o",
                       str(tmp_path / "out"), "--profile-dir",
                       str(tmp_path / "trace")]) == 0
    [found] = traces(tmp_path / "trace")
    cpu = {e["name"] for e in trace_events(found)
           if e.get("ph") == "X" and e.get("cat") in ("user_annotation",
                                                      "cpu_op")}
    assert {"bulk.job", "bulk.ingest", "boot.draw", "boot.batches"} <= cpu


def test_failing_run_raises_as_before_and_leaves_its_trace(tmp_path):
    """A BAM that does not exist: the same error with the option as
    without it, and the trace is written all the same."""
    argv = ["--alignments", str(tmp_path / "missing.bam"), "-o",
            str(tmp_path / "out"), "--device", "cpu", "--quiet"]
    errors = []
    for extra in ([], ["--profile-dir", str(tmp_path / "trace")]):
        with pytest.raises(Exception) as info:
            torch_main(argv + extra)
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1]
    assert "missing.bam" in errors[0][1]
    found = traces(tmp_path / "trace")
    assert len(found) == 1 and trace_events(found[0])


def test_missing_card_still_raises(runs, tmp_path, monkeypatch):
    """The default device is `cuda`: without a card the run raises as it
    does without the option, and the profiler neither picks another device
    nor swallows the error."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--alignments", str(runs / "bulk.bam"), "-o",
            str(tmp_path / "out"), "--quiet"]
    errors = []
    for extra in ([], ["--profile-dir", str(tmp_path / "trace")]):
        with pytest.raises(RuntimeError) as info:
            torch_main(argv + extra)
        errors.append(str(info.value))
    assert errors[0] == errors[1] and "no CUDA device" in errors[0]
    assert len(traces(tmp_path / "trace")) == 1
    assert not list(tmp_path.glob("out.*"))


def test_two_processes_leave_two_traces(runs, tmp_path):
    """Each process of a `--num-processes` run names its trace after its
    host and pid: two files, neither overwritten."""
    run_two_processes(
        ["--alignments", str(runs / "bulk.bam"), *BASE, "--device", "cpu",
         "--num-processes", "2", "--profile-dir", str(tmp_path / "trace")],
        tmp_path)
    found = traces(tmp_path / "trace")
    assert len(found) == 2, found
    assert all(trace_events(p) for p in found)
    # two processes add in another order: `test_torch_package.py`'s bar
    np.testing.assert_allclose(quant_counts(tmp_path / "p0.quant"),
                               quant_counts(runs / "plain.quant"),
                               rtol=1e-6, atol=1e-6)


CPU, CUDA = ProfilerActivity.CPU, ProfilerActivity.CUDA
BAM = ["--alignments", "x.bam", "-o", "out"]


@pytest.mark.parametrize("argv,card,want", [
    (BAM + ["--device", "cpu"], True, [CPU]),
    (BAM, True, [CPU, CUDA]),
    (BAM + ["--device", "cuda:0"], True, [CPU, CUDA]),
    (BAM, False, [CPU]),
    (["--only-index", "--index-out", "i.otmi", "--annotated", "t.fa"], True,
     [CPU]),
], ids=["cpu", "default", "cuda0", "no_card", "only_index"])
def test_profile_activities(argv, card, want, monkeypatch):
    """The card's activity is traced where the run asks for a card and one
    is present; `--device cpu` never asks whether one is (no CUDA call),
    and `--only-index` is host work."""
    def is_available():
        if "cpu" in argv:
            raise AssertionError("a --device cpu run asked for CUDA")
        return card

    monkeypatch.setattr(torch.cuda, "is_available", is_available)
    args = to_args(build_parser().parse_args(argv))
    assert profile_activities(args) == want


def test_chip_smoke_reads_kernels_and_busy_share_from_a_trace():
    """`chip_smoke.py`'s `cli_profile` arithmetic on a made-up trace: each
    hand-written kernel counted under its launch counter (both route-stage
    variants as `route_stage`), and the union of device intervals over the
    profiled span and over the EM's (first to last hand-written kernel)."""
    import chip_smoke

    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [
        x("Trace", "PyTorch Profiler (0)", 0.0, 1000.0),
        x("cpu_op", "aten::add", 5.0, 50.0),
        x("kernel", "void sorted_gather_kernel<float>(float const*)", 100.0,
          10.0),
        x("kernel", "void at::native::elementwise_kernel<...>", 105.0, 20.0),
        x("kernel", "void route_stage_shared_kernel<float>(...)", 200.0,
          5.0),
        x("kernel", "void route_stage_gather_kernel<float>(...)", 300.0,
          5.0),
        x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 400.0, 100.0),
        x("kernel", "void row_sums_kernel<double>(...)", 500.0, 10.0),
        x("kernel", "void row_sums_kernel<double>(...)", 505.0, 10.0),
    ]
    counts, names = chip_smoke.trace_kernel_counts(events)
    assert counts == {"sorted_gather": 1, "tile_permute": 0,
                      "route_stage": 2, "route_middle": 0, "row_sums": 2}
    assert len(names) == 4
    got = chip_smoke.busy_shares(events)
    # kernels 100-125, 200-205, 300-305, 500-515: 50 of 1,000 µs
    assert got["kernel_busy_share"] == pytest.approx(0.05)
    assert got["device_busy_share"] == pytest.approx(0.15)
    assert got["em_span_s"] == pytest.approx(415e-6)
    assert got["em_kernel_busy_share"] == pytest.approx(50 / 415)
    assert got["kernels"] == 6 and got["span_s"] == pytest.approx(1e-3)
    # no `Trace` event: the span of every event
    got = chip_smoke.busy_shares(events[1:])
    assert got["span_s"] == pytest.approx(510e-6)


@pytest.mark.parametrize("intervals,lo,hi,want", [
    ([], 0.0, 10.0, 0.0),
    ([(0.0, 2.0), (1.0, 3.0)], 0.0, 10.0, 3.0),
    ([(1.0, 9.0), (2.0, 3.0), (4.0, 12.0)], 0.0, 10.0, 9.0),
    ([(-5.0, 1.0), (8.0, 20.0)], 0.0, 10.0, 3.0),
], ids=["empty", "overlap", "nested_and_clipped", "outside"])
def test_union_of_intervals(intervals, lo, hi, want):
    import chip_smoke

    assert chip_smoke.union_us(intervals, lo, hi) == pytest.approx(want)
