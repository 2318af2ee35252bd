"""The profiler's trace of a window, reduced to device intervals on the
host's clock.

`torch.profiler` runs over the whole window with CUDA activity. A spin
kernel launched on the idle card while the host clock is read ties the
trace's clock to `time.time()`, so that the program's log lines (which
carry host times) can name what the host was doing around each device
interval and each idle gap.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# the kernel of `torch.cuda._sleep` (ATen's `spin_kernel`)
SYNC = "spin_kernel"


@dataclass
class DeviceTrace:
    """Device events of a traced window, in host seconds (`time.time()`)."""

    window: Tuple[float, float]
    starts: np.ndarray  # [n] float64, sorted
    ends: np.ndarray  # [n]
    names: List[str]
    is_kernel: np.ndarray  # [n] bool: a kernel (not a copy or a set)
    totals: Dict[str, float] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def merge(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """[k, 2] the union of the intervals, sorted and disjoint."""
    if len(starts) == 0:
        return np.empty((0, 2))
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > run_end[:-1]
    first = np.nonzero(new)[0]
    last = np.r_[first[1:] - 1, len(s) - 1]
    return np.stack([s[first], run_end[last]], axis=1)


def clip(iv: np.ndarray, lo: float, hi: float) -> np.ndarray:
    if len(iv) == 0:
        return iv
    out = np.stack([np.maximum(iv[:, 0], lo), np.minimum(iv[:, 1], hi)], 1)
    return out[out[:, 1] > out[:, 0]]


def busy_s(iv: np.ndarray) -> float:
    return float((iv[:, 1] - iv[:, 0]).sum()) if len(iv) else 0.0


def gaps(iv: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """[k, 2] the stretches of [lo, hi] that `iv` (merged) leaves free."""
    iv = clip(iv, lo, hi)
    edges = np.r_[lo, iv.ravel(), hi].reshape(-1, 2)
    return edges[edges[:, 1] > edges[:, 0]]


def top(pairs: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(pairs.items(),
                                      key=lambda kv: -kv[1])[:n]]


@contextlib.contextmanager
def profiled(enabled: bool, on_card: bool = True):
    """`torch.profiler` over the block when `enabled`; yields a holder
    whose `.trace` is the `DeviceTrace` once the block has ended. On the
    card only CUDA activity is traced (kernels, copies, sets and the
    runtime calls that launch them): the host's phases come from the
    program's log lines. Off the card (the CPU tests) the trace holds no
    device event."""
    holder = _Holder()
    if not enabled:
        yield holder
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        if on_card:
            # a spin kernel on an idle card starts when it is launched:
            # its start in the trace is `sync_wall` on the host's clock
            torch.cuda.synchronize()
            holder.sync_wall = time.time()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        holder.window_start = time.time()
        yield holder
        if on_card:
            torch.cuda.synchronize()
        holder.window_end = time.time()
    holder.trace = reduce_events(prof.profiler.kineto_results.events(),
                                 holder.sync_wall,
                                 (holder.window_start, holder.window_end))


class _Holder:
    trace: Optional[DeviceTrace] = None
    sync_wall = window_start = window_end = 0.0


COPIES = ("Memcpy", "Memset", "memcpy", "memset")


def reduce_events(events: Sequence, sync_wall: float,
                  window: Tuple[float, float]) -> DeviceTrace:
    """Device events (kernels, copies, sets) placed on the host clock by
    the sync kernel's start: the trace's first device event, launched on
    an idle card. One call to each event for its device: a traced window
    holds millions of events."""
    from torch._C._autograd import DeviceType

    cuda = DeviceType.CUDA
    starts, ends, names = [], [], []
    for ev in events:
        if ev.device_type() != cuda:
            continue
        starts.append(ev.start_ns())
        ends.append(ev.end_ns())
        names.append(ev.name())
    kern = [not n.startswith(COPIES) for n in names]
    sync_ns = 0
    if starts:
        first = int(np.argmin(starts))
        sync_ns = starts.pop(first)
        ends.pop(first)
        kern.pop(first)
        if SYNC not in names.pop(first):
            raise RuntimeError(f"the trace's first kernel is not {SYNC}")
    off = sync_wall - sync_ns * 1e-9
    s = np.asarray(starts, dtype=np.float64) * 1e-9 + off
    e = np.asarray(ends, dtype=np.float64) * 1e-9 + off
    order = np.argsort(s, kind="stable")
    totals: Dict[str, float] = defaultdict(float)
    for name, a, b in zip(names, s, e):
        totals[name] += b - a
    return DeviceTrace(window=window, starts=s[order], ends=e[order],
                       names=[names[i] for i in order],
                       is_kernel=np.asarray(kern, dtype=bool)[order],
                       totals=dict(totals))


def device_busy(trace: DeviceTrace, lo: float, hi: float,
                kernels_only: bool = False) -> float:
    """Seconds of [lo, hi] in which the card ran a kernel (or, unless
    `kernels_only`, a copy or a set)."""
    keep = trace.is_kernel if kernels_only else slice(None)
    iv = merge(trace.starts[keep], trace.ends[keep])
    return busy_s(clip(iv, lo, hi))


def breakdown(trace: DeviceTrace, jobs) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the host phase (of the job around them) at their
    middle."""
    lo, hi = trace.window
    idle = gaps(merge(trace.starts, trace.ends), lo, hi)
    lengths = idle[:, 1] - idle[:, 0]
    named = []
    for k in np.argsort(-lengths)[:10]:
        mid = 0.5 * (idle[k, 0] + idle[k, 1])
        named.append([phase_of(jobs, mid), float(lengths[k])])
    return {"device_ops": top(trace.totals), "idle_gaps": named}


def phase_of(jobs, t: float) -> str:
    for job in jobs:
        if job.start <= t <= job.end:
            return job.phase_at(t)
    return "between_jobs"
