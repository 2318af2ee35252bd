"""The program's INFO log lines of one job, captured with their host
times, and what the benchmark reads from them.

The patterns are copies of `oarfish_tpu_torch/bench.py::PhaseCapture`
and `bench_modes.py::ScPhases`, with the log lines of
`quant/bulk.py` that those two do not read (the CSR's sizes, the plan
cache), kept here so that the yardstick does not move with the program.
"""

from __future__ import annotations

import contextlib
import logging
import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

LOGGER = "oarfish_tpu_torch"

EM = re.compile(r"(\w+) EM on \S+ \(\w+\) converged after (\d+) "
                r"iterations in ([0-9.]+)s")
ROUTING = re.compile(r"(v[34]) routing built in ([0-9.]+)s")
AUTO = re.compile(r"^em-impl auto -> (\w+)")
PARSED = re.compile(r"^Parsing of alignments from input took ([0-9.]+)s")
BOOT = re.compile(r"^(\d+) bootstrap replicates in ([0-9.]+)s, "
                  r"iterations \[([0-9, ]*)\]")
SC_PHASE = re.compile(r"^phase (sc\.\w+) ([0-9.]+)")
RECORDS = re.compile(r"^Total number of alignment records : (\d+)")
READS = re.compile(r"^number of aligned reads : (\d+)")
TXPS = re.compile(r"^parsed reference information for (\d+) transcripts")
PLAN_HIT = re.compile(r"v4 plan (prefetch|cache) hit")


@dataclass
class JobLog:
    """One job: its host times (`time.time()`) and its log lines."""

    start: float
    end: float = 0.0
    lines: List[Tuple[float, str]] = field(default_factory=list)

    def find(self, pattern: re.Pattern) -> Optional[Tuple[float, re.Match]]:
        """The first line that `pattern` matches, with its time."""
        for t, msg in self.lines:
            m = pattern.search(msg)
            if m:
                return t, m
        return None

    def number(self, pattern: re.Pattern, group: int = 1) -> Optional[float]:
        hit = self.find(pattern)
        return None if hit is None else float(hit[1].group(group))

    def plan_hits(self) -> List[str]:
        return [msg for _, msg in self.lines if PLAN_HIT.search(msg)]

    def boot(self) -> Optional[Tuple[float, float, List[int]]]:
        """(end time, seconds, iterations of each replicate) of the
        bootstrap line, or None."""
        hit = self.find(BOOT)
        if hit is None:
            return None
        t, m = hit
        iters = [int(x) for x in m.group(3).split(",") if x.strip()]
        return t, float(m.group(2)), iters

    def marks(self) -> List[Tuple[float, str]]:
        """(time, name of the phase that ends there), in time order: the
        host's phases of the job, from its log lines."""
        out = []
        for pattern, name in ((PARSED, "ingest"), (AUTO, "stats"),
                              (ROUTING, "route"), (EM, "em")):
            hit = self.find(pattern)
            if hit:
                out.append((hit[0], name))
        boot = self.boot()
        if boot:
            out.append((boot[0] - boot[1], "write.quant"))
            out.append((boot[0], "bootstrap"))
        for t, msg in self.lines:
            m = SC_PHASE.search(msg)
            if m:
                out.append((t, {"sc.parse": "ingest", "sc.em": "sc_em",
                                "sc.write": "write"}.get(m.group(1),
                                                         m.group(1))))
        out.sort()
        # what follows the last line: the writers, unless a line already
        # closed them
        last = out[-1][1] if out else ""
        out.append((self.end, "finish" if last == "write" else "write"))
        return out

    def phase_at(self, t: float) -> str:
        for when, name in self.marks():
            if t <= when:
                return name
        return "after"


def mean(values) -> Optional[float]:
    """The mean of the values that are not None; None when there are
    none."""
    vals = [v for v in values if v is not None]
    return sum(vals) / len(vals) if vals else None


def sc_phase(job: JobLog, name: str) -> Optional[float]:
    """The seconds of the job's line `phase <name> <seconds>`."""
    for _, msg in job.lines:
        m = SC_PHASE.search(msg)
        if m and m.group(1) == name:
            return float(m.group(2))
    return None


class Capture(logging.Handler):
    """Collects the program's log lines into the current `JobLog`."""

    def __init__(self):
        super().__init__(level=logging.INFO)
        self.job: Optional[JobLog] = None

    def emit(self, record):
        if self.job is not None:
            self.job.lines.append((record.created, record.getMessage()))


@contextlib.contextmanager
def captured():
    """The program's INFO lines go to the yielded `Capture` (and nowhere
    else that this module adds) while the block runs."""
    handler = Capture()
    logger = logging.getLogger(LOGGER)
    level, propagate = logger.level, logger.propagate
    logger.setLevel(logging.INFO)
    logger.propagate = False
    logger.addHandler(handler)
    try:
        yield handler
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
        logger.propagate = propagate
