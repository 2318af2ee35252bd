"""The per-layer readers on recorded log lines and a made-up device
trace."""

import numpy as np
import pytest

from perfbench import spec
from perfbench.logs import JobLog
from perfbench.roofline import PEAKS, em_least_bytes
from perfbench.trace import DeviceTrace, breakdown, merge

T0 = 1_700_000_000.0
ITERS = [300 + (7 * i) % 50 for i in range(100)]
BULK = [
    (0.10, "parsed reference information for 200000 transcripts."),
    (3.20, "Parsing of alignments from input took 3.200s"),
    (3.25, "Total number of alignment records : 3001234"),
    (3.25, "number of aligned reads : 1000000"),
    (3.25, "number of unique alignments : 299876"),
    (3.40, "em-impl auto -> v4"),
    (5.40, "v4 routing built in 2.0s"),
    (5.40, "v4 layout: 161 big transcripts, fused middle"),
    (5.60, "v4 EM on cuda:0 (float32) converged after 286 iterations "
           "in 0.183s"),
    (22.0, "100 bootstrap replicates in 15.500s, iterations "
           f"[{', '.join(map(str, ITERS))}]"),
]
SC = [
    (2.00, "parsed 5000 cells (0 with no surviving alignments, 2500000 "
           "reads kept) in 2s; 9 size buckets (14 before coarsening)"),
    (2.00, "phase sc.parse 1.980"),
    (8.10, "ran 5000 cell EMs on cuda:0 (float32) in 6s 100ms"),
    (8.10, "phase sc.em 6.100"),
    (8.50, "phase sc.write 0.400"),
]


def job(lines, end):
    j = JobLog(start=T0, end=T0 + end)
    j.lines = [(T0 + t, msg) for t, msg in lines]
    return j


class Run:
    def __init__(self, jobs, trace=None):
        self.jobs, self.trace = jobs, trace


def read(name, run):
    return spec.reader(name)(run)


def trace_of(intervals, window):
    iv = np.asarray(intervals, dtype=np.float64) + T0
    return DeviceTrace(window=(T0 + window[0], T0 + window[1]),
                       starts=iv[:, 0], ends=iv[:, 1],
                       names=["k"] * len(iv),
                       is_kernel=np.ones(len(iv), bool),
                       totals={"k": float((iv[:, 1] - iv[:, 0]).sum())})


def test_bulk_readers():
    run = Run([job(BULK, 23.0), job(BULK, 23.0)])
    assert read("ingest_s.bulk", run) == pytest.approx(3.2)
    assert read("route_build_s", run) == pytest.approx(2.0)
    assert read("em_ms_per_iter", run) == pytest.approx(183 / 286)
    assert read("boot_s_per_replicate", run) == pytest.approx(0.155)
    for name in ("ingest_s.sc", "sc_em_s", "em_roofline",
                 "device_idle_pct"):
        assert read(name, run) is None


def test_single_cell_readers():
    run = Run([job(SC, 8.6), job([(2.5, "phase sc.parse 2.5"),
                                  (9.0, "phase sc.em 7.0")], 9.2)])
    # from each job's start to its `phase sc.parse` line
    assert read("ingest_s.sc", run) == pytest.approx((2.0 + 2.5) / 2)
    assert read("sc_em_s", run) == pytest.approx((6.1 + 7.0) / 2)
    assert read("ingest_s.bulk", run) is None
    assert read("route_build_s", run) is None


def test_roofline_and_idle_from_the_trace():
    # kernels busy 1.5 s between the EM's start (5.4) and the bootstrap's
    # end (22.0); a copy outside it
    tr = trace_of([[1.0, 1.5], [6.0, 6.5], [10.0, 11.0], [30.0, 31.0]],
                  (0.0, 40.0))
    tr.is_kernel[0] = False
    run = Run([job(BULK, 23.0)], tr)
    least = em_least_bytes(3001234, 1000000, 200000, 287,
                           [i + 1 for i in ITERS])
    assert read("em_roofline", run) == pytest.approx(
        100 * least / PEAKS["hbm_bytes_per_s"] / 1.5)
    assert read("device_idle_pct", run) == pytest.approx(100 * (1 - 3 / 40))


def test_breakdown_names_gaps_by_phase():
    tr = trace_of([[4.0, 5.5], [6.0, 21.5]], (0.0, 23.0))
    out = breakdown(tr, [job(BULK, 23.0)])
    assert out["device_ops"] == [["k", pytest.approx(17.0)]]
    names = [n for n, _ in out["idle_gaps"]]
    assert names[0] == "ingest"  # 0.0-4.0, the pack
    assert "write" in names  # 21.5-23.0, after the bootstrap line
    assert all(s > 0 for _, s in out["idle_gaps"])


def test_merge_unions_overlaps():
    iv = merge(np.array([3.0, 0.0, 1.0, 5.0]), np.array([4.0, 2.0, 1.5, 6.0]))
    assert iv.tolist() == [[0.0, 2.0], [3.0, 4.0], [5.0, 6.0]]


class Ev:
    def __init__(self, act, name, start, end):
        from torch._C._autograd import DeviceType

        self.d = DeviceType.CPU if act == "cuda_runtime" else DeviceType.CUDA
        self.n, self.s, self.e = name, start, end

    def device_type(self):
        return self.d

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e


def test_events_are_placed_by_the_sync_kernel():
    from perfbench.trace import reduce_events

    evs = [Ev("cuda_runtime", "cudaLaunchKernel", 10, 20),
           Ev("kernel", "k1", 5_000_000_000, 5_500_000_000),
           Ev("kernel", "void spin_kernel(long)", 1_000_000_000,
              1_000_001_000),
           Ev("gpu_memcpy", "Memcpy HtoD", 6_000_000_000, 6_250_000_000)]
    tr = reduce_events(evs, T0, (T0, T0 + 10))
    assert tr.names == ["k1", "Memcpy HtoD"]
    assert tr.starts.tolist() == pytest.approx([T0 + 4.0, T0 + 5.0])
    assert tr.is_kernel.tolist() == [True, False]
    assert tr.totals == pytest.approx({"k1": 0.5, "Memcpy HtoD": 0.25})
    with pytest.raises(RuntimeError):
        reduce_events(evs[1:2], T0, (T0, T0 + 10))
