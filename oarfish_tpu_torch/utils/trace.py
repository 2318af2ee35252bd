"""Spans and counters: the port's one timing mechanism.

`span(name, **attrs)` times a block of host code. When the block ends it
emits one INFO line on the `oarfish_tpu_torch` logger:

    phase <name> <seconds> job=<n> parent=<name> start=<epoch> [k=v ...]

`start` is `time.time()` at the block's start: the clock that `logging`
stamps lines with, and the one a profiler trace can be tied to.
`seconds` is taken with `time.perf_counter()`. `parent` is the span
open around it on the same thread (`-` for none), and `job` the number
of the process's current job (`job()` opens a span and counts a new
one). While a `torch.profiler` records, a span is also a
`torch.profiler.record_function` range, so that it sits on the
profiler's timeline beside the kernels; a profile that records only the
device's activity gets nothing from it.

A span never synchronizes the device. Where the device work of a block
has to count, the block ends after a synchronization its code makes
anyway (a `.cpu()` of the result). Spans mark phases, never single
m-steps or launches: a tight loop counts instead.

`lap(label)` closes a stretch of the innermost open span: it emits the
line of a child span `<span>.<label>` from the previous lap (or the
span's start) to now, for code whose phases follow one another without
a block of their own. A lap is a log line only, not a profiler range.
`annotate(**attrs)` adds attributes to the innermost open span.

The counter registry (`count`, `counter`) holds the process's counts:
`launch.<kernel>` for each launch of a hand-written kernel, with
`launch.<kernel>.<variant>` and `launch.<kernel>.replicate` beside it. A
span takes the change of counters over its life as attributes
(`deltas`).

With the logger above INFO nothing is emitted and counters still count.
"""

from __future__ import annotations

import logging
import re
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Union

log = logging.getLogger("oarfish_tpu_torch")

LINE = re.compile(r"^phase (\S+) ([0-9.]+) job=(\d+) parent=(\S+) "
                  r"start=([0-9.]+)((?: \S+=\S*)*)$")

_local = threading.local()
# each thread counts into its own tally, so that a count takes no lock; a
# counter is the sum of the tallies
_tallies: List[Dict[str, Union[int, float]]] = []
_tallies_lock = threading.Lock()
_job = 0


def _stack() -> List["Span"]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _profiling() -> bool:
    from torch.autograd import profiler

    return profiler._is_profiler_enabled


def _value(v) -> str:
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, float):
        return f"{v:.6f}"
    return str(v).replace(" ", "_")


def _emit(name: str, seconds: float, job: int, parent: str, start: float,
          attrs: dict) -> None:
    if log.isEnabledFor(logging.INFO):
        log.info("phase %s %.6f job=%d parent=%s start=%.6f%s", name,
                 seconds, job, parent, start,
                 "".join(f" {k}={_value(v)}" for k, v in attrs.items()))


def _read(source: Union[str, Callable[[], float]]):
    return source() if callable(source) else counter(source)


class Span:
    """One timed block; see the module's docstring. After the block,
    `seconds` holds its length and `laps` the seconds of each lap."""

    def __init__(self, name: str,
                 deltas: Optional[Dict[str, Union[str, Callable]]],
                 attrs: dict):
        self.name = name
        self.attrs = attrs
        self.deltas = deltas
        self.laps: Dict[str, float] = {}
        self.seconds = 0.0
        self.start = 0.0
        self.parent = "-"
        self.job = 0
        self._before: Dict[str, float] = {}
        self._range = None
        self._t0 = self._lap = 0.0

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def lap(self, label: str) -> None:
        now = time.perf_counter()
        self.laps[label] = now - self._lap
        _emit(f"{self.name}.{label}", now - self._lap, self.job, self.name,
              self.start + (self._lap - self._t0), {})
        self._lap = now

    def __enter__(self) -> "Span":
        stack = _stack()
        if stack:
            self.parent = stack[-1].name
        stack.append(self)
        self.job = _job
        if self.deltas:
            self._before = {k: _read(s) for k, s in self.deltas.items()}
        if _profiling():
            import torch

            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start = time.time()
        self._t0 = self._lap = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.seconds = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        for k, s in (self.deltas or {}).items():
            self.attrs[k] = _read(s) - self._before[k]
        if exc_type is not None:
            self.attrs["raised"] = exc_type.__name__
        _emit(self.name, self.seconds, self.job, self.parent, self.start,
              self.attrs)
        return False


def span(name: str, deltas: Optional[Dict[str, Union[str, Callable]]] = None,
         **attrs) -> Span:
    """A span to open with `with`; `deltas` maps an attribute to a
    counter's name (or a function of no arguments) whose change over the
    span's life the attribute takes."""
    return Span(name, deltas, attrs)


def job(name: str) -> Span:
    """A span that starts the process's next job."""
    global _job
    _job += 1
    return Span(name, None, {})


def lap(label: str) -> None:
    """`Span.lap` on the innermost open span of this thread; nothing
    without one."""
    stack = _stack()
    if stack:
        stack[-1].lap(label)


def annotate(**attrs) -> None:
    """Attributes for the innermost open span of this thread; nothing
    without one."""
    stack = _stack()
    if stack:
        stack[-1].set(**attrs)


def _tally() -> Dict[str, Union[int, float]]:
    try:
        return _local.tally
    except AttributeError:
        tally = _local.tally = {}
        with _tallies_lock:
            _tallies.append(tally)
        return tally


def count(name: str, n: Union[int, float] = 1) -> None:
    tally = _tally()
    tally[name] = tally.get(name, 0) + n


def counter(name: str) -> Union[int, float]:
    return sum(tally.get(name, 0) for tally in list(_tallies))


def launches() -> int:
    """Launches of the hand-written kernels so far: the `launch.<kernel>`
    counters, without their variants."""
    return sum(v for tally in list(_tallies) for k, v in list(tally.items())
               if k.startswith("launch.") and k.count(".") == 1)


def reset(prefix: str = "") -> None:
    """Set the counters whose names start with `prefix` to 0 (while no
    other thread counts)."""
    for tally in list(_tallies):
        for k in list(tally):
            if k.startswith(prefix):
                tally[k] = 0


class SpanLine(NamedTuple):
    name: str
    seconds: float
    job: int
    parent: str
    start: float
    attrs: dict

    @property
    def end(self) -> float:
        return self.start + self.seconds


def _number(v: str):
    try:
        return int(v)
    except ValueError:
        try:
            return float(v)
        except ValueError:
            return v


def parse(msg: str) -> Optional[SpanLine]:
    """The span of a log line, or None for any other line."""
    m = LINE.match(msg)
    if m is None:
        return None
    attrs = dict(kv.split("=", 1) for kv in m.group(6).split())
    return SpanLine(m.group(1), float(m.group(2)), int(m.group(3)),
                    m.group(4), float(m.group(5)),
                    {k: _number(v) for k, v in attrs.items()})
