"""The reader `metrics/boot_draw_wait_s.py`: the seconds a job's
bootstrap batches waited for the host's draw, from the attribute
`draw_wait_s` of the span `boot.batches`, on recorded span lines; None
for a program whose batches carry no such attribute, and for a log
without spans."""

import pytest

from perfbench import spec
from perfbench.logs import JobLog

from .test_perfbench_logs import BULK

T0 = 1_700_000_000.0


class Run:
    def __init__(self, jobs):
        self.jobs, self.trace = jobs, None


def span_line(name, start, seconds, parent="bulk.job", **attrs):
    tail = "".join(f" {k}={v}" for k, v in attrs.items())
    return (start + seconds,
            f"phase {name} {seconds:.6f} job=1 parent={parent} "
            f"start={T0 + start:.6f}{tail}")


def job_of(lines, end=17.0):
    j = JobLog(start=T0, end=T0 + end)
    j.lines = [(T0 + t, msg) for t, msg in lines]
    return j


def batches(start, **attrs):
    return span_line("boot.batches", start, 4.0, batches=13, batch=8,
                     useful_steps=900, slot_steps=1200, launches=3000,
                     **attrs)


def read(r):
    return spec.reader("boot_draw_wait_s")(r)


def test_the_wait_of_each_job_averaged():
    waited = [span_line("boot.draw", 1.0, 3.5, parent="-"),
              batches(7.8, draw_wait_s="0.250000", draws_waited=2)]
    # the draw was done before the batches: no wait, written as 0
    ahead = [batches(7.8, draw_wait_s=0, draws_waited=0)]
    assert read(Run([job_of(waited), job_of(ahead)])) == pytest.approx(0.125)
    # two batch spans in one job (replicates run in two calls) add up
    twice = [batches(7.8, draw_wait_s="0.100000", draws_waited=1),
             batches(12.0, draw_wait_s="0.300000", draws_waited=1)]
    assert read(Run([job_of(twice)])) == pytest.approx(0.4)


def test_nothing_to_read_without_the_attribute():
    """The program before the draw's thread: its batches carry no
    `draw_wait_s`, and the reader returns None, as it does for a log
    without spans and for no job."""
    parent = [span_line("boot.draw", 7.8, 4.0, replicates=16),
              batches(11.8)]
    for r in (Run([job_of(parent)]), Run([job_of(BULK, 23.0)]), Run([])):
        assert read(r) is None
