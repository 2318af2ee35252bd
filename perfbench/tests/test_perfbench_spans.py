"""The six readers of the program's spans (`perfbench/spans.py`,
`metrics/{boot_draw_s,boot_step_efficiency,write_s.bulk,layout_build_s,
launches_per_mstep,boot_idle_pct}.py`): on a traced run of the program
on the CPU, on recorded span lines with a made-up device trace, and on a
log without spans, where each returns None."""

import io

import numpy as np
import pytest
import torch

from perfbench import run, spec
from perfbench.logs import JobLog
from perfbench.spans import parse, spans
from perfbench.trace import DeviceTrace

from .conftest import tiny
from .test_perfbench_logs import BULK

READERS = ("boot_draw_s", "boot_step_efficiency", "write_s.bulk",
           "layout_build_s", "launches_per_mstep", "boot_idle_pct")
# what a run on the CPU gives them: the segment-sum EM (no v4 route) and
# no device event
ON_CPU = ("boot_draw_s", "boot_step_efficiency", "write_s.bulk")
T0 = 1_700_000_000.0


def read(name, r):
    return spec.reader(name)(r)


class Run:
    def __init__(self, jobs, trace=None):
        self.jobs, self.trace = jobs, trace


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_readers_are_the_cells_metrics():
    names = [m["name"] for m in spec.load_cell("bulk-boot100").per_layer]
    assert set(READERS) <= set(names)


def test_readers_on_a_traced_cpu_run(tmp_path):
    err = io.StringIO()
    line = run.run_cell(tiny("bulk-boot100"), 2**31 + 29, 1.0, True,
                        device="cpu", cache=tmp_path / "cache", stderr=err)
    assert line["correct"], err.getvalue()
    got = line["metrics"]
    assert set(ON_CPU) <= set(got), got
    assert all(got[n]["value"] > 0 for n in ON_CPU)
    assert 0 < got["boot_step_efficiency"]["value"] <= 1
    for name in set(READERS) - set(ON_CPU):
        assert name not in got, name


def span_line(name, start, seconds, parent="bulk.job", **attrs):
    tail = "".join(f" {k}={v}" for k, v in attrs.items())
    return (start + seconds,
            f"phase {name} {seconds:.6f} job=1 parent={parent} "
            f"start={T0 + start:.6f}{tail}")


JOB = [
    span_line("bulk.ingest", 0.0, 5.0),
    span_line("v4.layout", 5.5, 1.2, parent="bulk.route"),
    span_line("bulk.route", 5.4, 1.8, impl="v4"),
    span_line("bulk.em", 7.2, 0.5, impl="v4", iters=99, msteps=100,
              launches=400),
    span_line("bulk.write.quant", 7.7, 0.1),
    span_line("boot.draw", 7.8, 4.0, replicates=16, reads=500000),
    span_line("boot.batches", 11.8, 4.0, batches=2, batch=8,
              useful_steps=900, slot_steps=1200, launches=3000),
    span_line("bulk.write.infreps", 15.8, 0.6),
    span_line("bulk.write.probs", 16.4, 0.0),
]


def job_of(lines, end=17.0):
    j = JobLog(start=T0, end=T0 + end)
    j.lines = [(T0 + t, msg) for t, msg in lines]
    return j


def device(kernels, copies=()):
    """A trace of kernels and copies given as (start, end) offsets."""
    iv = [(a, b, True) for a, b in kernels] + [(a, b, False)
                                               for a, b in copies]
    iv.sort()
    s = np.array([a for a, _, _ in iv]) + T0
    e = np.array([b for _, b, _ in iv]) + T0
    return DeviceTrace(window=(T0, T0 + 17.0), starts=s, ends=e,
                       names=["k"] * len(iv),
                       is_kernel=np.array([k for _, _, k in iv]),
                       totals={})


def test_readers_on_recorded_spans():
    # 1,500 kernels inside the EM (7.2-7.7), one before it; the batches
    # (11.8-15.8) busy 3.3 s, a copy of them included
    em = [(7.2 + i * 3e-4, 7.2 + i * 3e-4 + 1e-4) for i in range(1500)]
    trace = device(em + [(7.0, 7.1), (11.8, 13.8), (14.3, 14.8)],
                   copies=[(15.0, 15.8)])
    other = [span_line("boot.draw", 7.8, 5.0), span_line(
        "boot.batches", 12.8, 2.0, useful_steps=100, slot_steps=100),
        span_line("bulk.write.quant", 7.7, 0.2)]
    r = Run([job_of(JOB), job_of(other)], trace)
    assert read("boot_draw_s", r) == pytest.approx(4.5)
    assert read("boot_step_efficiency", r) == pytest.approx(1000 / 1300)
    assert read("write_s.bulk", r) == pytest.approx((0.7 + 0.2) / 2)
    # the second job built no route and ran no point EM
    assert read("layout_build_s", r) == pytest.approx(1.2)
    assert read("launches_per_mstep", r) == pytest.approx(15.0)
    # the second job's batches (12.8-14.8) are busy 1.5 s of 2.0
    assert read("boot_idle_pct", r) == pytest.approx((17.5 + 25.0) / 2)


def test_the_spans_of_a_job():
    j = job_of(JOB + [(18.0, "phase sc.em 6.100"),
                      (18.0, "Parsing of alignments from input took 3s")])
    assert [s.name for s in spans(j, prefix="bulk.write.")] == [
        "bulk.write.quant", "bulk.write.infreps", "bulk.write.probs"]
    draw = spans(j, "boot.draw")[0]
    assert draw.start == pytest.approx(T0 + 7.8)
    assert draw.end == pytest.approx(T0 + 11.8)
    assert draw.number("reads") == 500000 and draw.number("x") is None
    assert parse("phase sc.em 6.100") is None


def test_readers_find_nothing_without_spans():
    """A program from before the spans (its log lines only), with and
    without a device trace: every reader returns None."""
    trace = device([(4.0, 5.5), (6.0, 21.5)])
    for r in (Run([job_of(BULK, 23.0)]), Run([job_of(BULK, 23.0)], trace),
              Run([])):
        for name in READERS:
            assert read(name, r) is None, name
