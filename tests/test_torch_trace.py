"""`oarfish_tpu_torch/utils/trace.py`: the port's spans and counters.

A span emits one INFO line when it ends, `phase <name> <seconds> job=<n>
parent=<name> start=<epoch> [k=v ...]`, and is a `record_function` range
while a profiler records; counters count whatever the logger's level. A
bulk job through the CLI (`--em-impl v4 --device cpu`, three bootstrap
replicates) emits the span tree of `quant/bulk.py`, every child inside
its parent.
"""

import logging
import time

import pytest
import torch

from oarfish_tpu_torch.cli import main as torch_main
from oarfish_tpu_torch.utils import trace
from util_torch import one_torch_thread  # noqa: F401 (autouse fixture)

LOGGER = "oarfish_tpu_torch"
R, T = 40_000, 2_000  # the size of `test_torch_em_v4_runs.py`'s CLI run


def spans_of(caplog):
    return [s for s in (trace.parse(r.getMessage()) for r in caplog.records)
            if s is not None]


def test_line_format(caplog):
    with caplog.at_level(logging.INFO, logger=LOGGER):
        t0 = time.time()
        with trace.span("test.outer", impl="v4", ratio=0.25, flag=True):
            time.sleep(0.01)
        t1 = time.time()
    [record] = caplog.records
    msg = record.getMessage()
    assert msg.startswith("phase test.outer ")
    head, attrs = msg.split(" start=")[0], msg.split(" start=")[1]
    assert head.split()[3:] == [f"job={trace._job}", "parent=-"]
    assert attrs.split()[1:] == ["impl=v4", "ratio=0.250000", "flag=1"]
    s = trace.parse(msg)
    assert (s.name, s.job, s.parent) == ("test.outer", trace._job, "-")
    assert t0 <= s.start <= s.end <= t1 + 1e-3
    assert 0.01 <= s.seconds <= t1 - t0 + 1e-3
    assert s.attrs == {"impl": "v4", "ratio": 0.25, "flag": 1}
    # the line's time is the span's end on the same clock
    assert abs(record.created - s.end) < 0.05
    assert trace.parse("phase sc.em 6.100") is None


def test_nesting_laps_and_attributes(caplog):
    with caplog.at_level(logging.INFO, logger=LOGGER):
        with trace.job("test.job") as job:
            with trace.span("test.child", a=1) as child:
                trace.annotate(b="x")
                child.set(c=2)
                trace.lap("first")
                trace.lap("second")
            with trace.span("test.sibling"):
                pass
        # a lap or attributes outside every span go nowhere
        trace.lap("nowhere")
        trace.annotate(d=4)
    got = {s.name: s for s in spans_of(caplog)}
    assert list(got) == ["test.child.first", "test.child.second",
                         "test.child", "test.sibling", "test.job"]
    assert {s.job for s in got.values()} == {job.job}
    assert job.job == trace._job
    assert got["test.job"].parent == "-"
    assert got["test.child"].parent == got["test.sibling"].parent == \
        "test.job"
    assert got["test.child.first"].parent == "test.child"
    assert got["test.child"].attrs == {"a": 1, "b": "x", "c": 2}
    assert list(child.laps) == ["first", "second"]
    first, second = got["test.child.first"], got["test.child.second"]
    assert first.start == pytest.approx(got["test.child"].start, abs=1e-6)
    assert second.start == pytest.approx(first.end, abs=1e-5)
    assert child.seconds >= sum(child.laps.values())
    # the next job is numbered one more
    with caplog.at_level(logging.INFO, logger=LOGGER):
        with trace.job("test.job"):
            pass
    assert spans_of(caplog)[-1].job == job.job + 1


def test_counter_deltas_on_a_span(caplog):
    trace.count("test.delta", 5)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        with trace.span("test.counted", {"n": "test.delta",
                                         "launches": trace.launches}) as sp:
            trace.count("test.delta")
            trace.count("test.delta", 2)
            trace.count("launch.test_kernel")
            trace.count("launch.test_kernel.replicate")
    assert sp.attrs == {"n": 3, "launches": 1}
    assert spans_of(caplog)[-1].attrs == {"n": 3, "launches": 1}
    assert trace.counter("test.delta") == 8
    trace.reset("test.")
    assert trace.counter("test.delta") == 0
    assert trace.counter("launch.test_kernel") == 1
    assert trace.counter("test.never") == 0


def test_counts_from_many_threads_are_not_lost():
    """Each thread counts into its own tally: 16 threads (more than the
    cores) counting at once, with the interpreter switching threads
    often, lose no count."""
    import sys
    import threading

    before = trace.counter("test.threads")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            trace.count("test.threads") for _ in range(5000)])
            for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert trace.counter("test.threads") == before + 16 * 5000


def test_nothing_above_info_but_counters_count(caplog):
    before = trace.counter("test.quiet")
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        with trace.span("test.quiet", {"n": "test.quiet"}) as sp:
            trace.count("test.quiet")
            trace.lap("lap")
    assert not caplog.records
    assert trace.counter("test.quiet") == before + 1
    assert sp.attrs == {"n": 1} and sp.seconds > 0


def test_a_span_that_raises_says_so(caplog):
    with caplog.at_level(logging.INFO, logger=LOGGER):
        with pytest.raises(KeyError):
            with trace.span("test.raises"):
                raise KeyError("x")
        with trace.span("test.after"):
            pass
    raised, after = spans_of(caplog)
    assert raised.attrs == {"raised": "KeyError"}
    # the stack is whole again
    assert after.parent == "-"


def test_record_function_range_in_a_cpu_profile():
    from torch.profiler import ProfilerActivity, profile

    with trace.span("test.unprofiled") as sp:
        pass
    assert sp._range is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("test.profiled"):
            torch.ones(8).sum()
    names = {e.name for e in prof.events()}
    assert "test.profiled" in names and "test.unprofiled" not in names


# the span tree of a bulk job: name -> its parent
TREE = {
    "bulk.job": "-",
    "bulk.ingest": "bulk.job", "bulk.pack": "bulk.ingest",
    "prebuild.finish": "bulk.ingest",
    "bulk.prepare": "bulk.job",
    "bulk.route": "bulk.job", "v4.layout": "bulk.route",
    "v4.finish": "bulk.route", "route.upload": "v4.finish",
    "bulk.em": "bulk.job", "bulk.write.quant": "bulk.job",
    "boot.batches": "bulk.job",
    "bulk.write.infreps": "bulk.job", "bulk.write.probs": "bulk.job",
    # on the draw's own thread
    "boot.draw": "-",
}
# the children of a job, one after another
JOB = ["bulk.ingest", "bulk.prepare", "bulk.route", "bulk.em",
       "bulk.write.quant", "boot.batches", "bulk.write.infreps",
       "bulk.write.probs"]


@pytest.fixture(scope="module")
def bulk_run(tmp_path_factory):
    from chip_smoke import build_e2e_bam

    tmp = tmp_path_factory.mktemp("trace")
    bam = tmp / "v4.bam"
    build_e2e_bam(bam, R, T, seed=3, threads=2)
    handler = Collect()
    logger = logging.getLogger(LOGGER)
    level = logger.level
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    try:
        assert torch_main(["--alignments", str(bam), "--device", "cpu",
                           "--em-impl", "v4", "--num-bootstraps", "3",
                           "--max-em-iter", "60", "--seed", "1", "-o",
                           str(tmp / "out")]) == 0
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    return handler.lines


class Collect(logging.Handler):
    def __init__(self):
        super().__init__(level=logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_bulk_job_span_tree(bulk_run):
    spans = [s for s in map(trace.parse, bulk_run) if s is not None]
    jobs = {s.job for s in spans}
    assert len(jobs) == 1
    named = {}
    for s in spans:
        named.setdefault(s.name, s)
    for name, parent in TREE.items():
        assert name in named, name
        assert named[name].parent == parent, name
    # every child lies inside its parent (the lines' numbers have six
    # decimals)
    for s in spans:
        if s.parent == "-":
            continue
        p = named[s.parent]
        assert p.start - 2e-6 <= s.start and s.end <= p.end + 2e-6, (
            s.name, s.parent)
    # the job's phases come one after another
    phases = [named[n] for n in JOB]
    for a, b in zip(phases, phases[1:]):
        assert a.end <= b.start + 2e-6, (a.name, b.name)
    assert named["v4.layout"].end <= named["v4.finish"].start + 2e-6
    # the draw starts before the route and ends inside the job
    draw, job = named["boot.draw"], named["bulk.job"]
    assert job.start - 2e-6 <= draw.start <= named["bulk.route"].start
    assert draw.end <= job.end + 2e-6
    laps = [s for s in spans if s.parent == "v4.layout"]
    assert laps and all(s.name.startswith("v4.layout.") for s in laps)


def test_bulk_job_span_attributes(bulk_run):
    spans = {}
    for s in map(trace.parse, bulk_run):
        if s is not None:
            spans.setdefault(s.name, s)
    em = spans["bulk.em"].attrs
    assert em["impl"] == "v4" and em["msteps"] == em["iters"] + 1
    assert em["launches"] == 0  # the plain versions on the CPU
    assert spans["bulk.route"].attrs == {"impl": "v4"}
    assert spans["boot.draw"].attrs["replicates"] == 3
    boot = spans["boot.batches"].attrs
    assert (boot["batches"], boot["batch"]) == (1, 8)
    [iters] = [ln for ln in bulk_run if "3 bootstrap replicates in" in ln]
    steps = [int(x) + 1 for x in iters.split("[")[1].rstrip("]").split(",")]
    # 3 replicates in 8 slots: none refilled, each slot left after its
    # final step, the learning of a freeze costing at most a step each
    assert boot["useful_steps"] == sum(steps)
    assert boot["useful_steps"] <= boot["slot_steps"] <= sum(steps) + 3
    assert boot["refills"] == 0
    assert max(steps) <= boot["msteps"] == boot["tail_steps"] <= max(steps) + 1
    if any(ln.startswith("streamed pack:") for ln in bulk_run):
        assert {"decode_wait_s", "filter_s", "tail_s", "wall_s",
                "chunks"} <= set(spans["bulk.pack"].attrs)
    # the lines the benchmark reads are there, in their order
    keys = ["Parsing of alignments from input took", "v4 routing built in",
            "v4 EM on cpu (float32) converged after",
            "3 bootstrap replicates in"]
    at = [next(i for i, ln in enumerate(bulk_run) if k in ln) for k in keys]
    assert at == sorted(at)


def test_chip_smoke_build_profile_reads_the_spans(bulk_run):
    """`chip_smoke.py`'s `build_phases_s` of a v4 build, from its spans:
    the two phases, each one's steps, the route tables' fill and upload."""
    import chip_smoke

    got = chip_smoke.build_phases(
        [s for s in map(trace.parse, bulk_run) if s is not None])
    assert {"layout", "finish", "layout.read_buckets",
            "layout.tile_permute_specs", "finish.seg_id_w_txp_tiles",
            "finish.routes_join_upload", "finish.color_and_fill_tables",
            "finish.upload_tables"} <= set(got)
    assert got["layout"] >= got["layout.read_buckets"]
