"""The program's span lines of a job, parsed, and what the per-layer
readers of the spans share.

A span line is `phase <name> <seconds> job=<n> parent=<name>
start=<epoch> [k=v ...]` (`oarfish_tpu_torch/utils/trace.py`): `start`
on the host's clock (`time.time()`), to which the device trace is tied,
and `seconds` from `time.perf_counter()`. The pattern is a copy of the
program's, kept here so that the yardstick does not move with the
program. A job of a program that emits no spans has none, and every
reader of them returns None.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

SPAN = re.compile(r"^phase (\S+) ([0-9.]+) job=(\d+) parent=(\S+) "
                  r"start=([0-9.]+)((?: \S+=\S*)*)$")


@dataclass
class Span:
    name: str
    seconds: float
    parent: str
    start: float
    attrs: dict

    @property
    def end(self) -> float:
        return self.start + self.seconds

    def number(self, key: str) -> Optional[float]:
        """The attribute `key` as a number, or None."""
        try:
            return float(self.attrs[key])
        except (KeyError, ValueError):
            return None


def parse(msg: str) -> Optional[Span]:
    m = SPAN.match(msg)
    if m is None:
        return None
    attrs = dict(kv.split("=", 1) for kv in m.group(6).split())
    return Span(m.group(1), float(m.group(2)), m.group(4),
                float(m.group(5)), attrs)


def spans(job, name: Optional[str] = None,
          prefix: Optional[str] = None) -> List[Span]:
    """The job's spans in the order they ended, those named `name` or
    starting with `prefix` where given."""
    out = []
    for _, msg in job.lines:
        s = parse(msg)
        if s is None or (name is not None and s.name != name):
            continue
        if prefix is not None and not s.name.startswith(prefix):
            continue
        out.append(s)
    return out


def first(job, name: str) -> Optional[Span]:
    found = spans(job, name)
    return found[0] if found else None


def kernels_starting(trace, lo: float, hi: float) -> int:
    """Device kernels (not copies or sets) of the trace that start in
    [lo, hi]."""
    a = np.searchsorted(trace.starts, lo, side="left")
    b = np.searchsorted(trace.starts, hi, side="right")
    return int(trace.is_kernel[a:b].sum())
