"""The benchmark of `oarfish_tpu_torch` on one card.

    python3 -m perfbench.run --workload NAME --seed N --seconds S --trace 0|1

A run takes the cell's fixed set of samples, made once in a checkout by
processes of their own and kept in `perfbench/.cache/`, in an order
drawn from `--seed` (so that every seed brings the same work), warms up
on a small job of the cell's configuration, then measures a window: a
closed loop of whole jobs, one at a time, each through the CLI's normal
path in this process with the route-plan cache off. After the traffic's
`min_jobs` (default 1), a further job starts only while the mean job
time so far says it will end by `--seconds`. The seed also draws the
replicates that the check compares. Once the window has closed it reads the peaks, frees
the program's state, judges every job's files against the plain
reference (`perfbench/check.py`) and prints one JSON line: the cell's
end-to-end metrics with `--trace 0`, its per-layer metrics (read by
`perfbench/metrics/<name>.py` from the log lines and the profiler's
trace) with `--trace 1`.

It exits with another code than 0, and prints no result, without a card
or the program, when a job hit the plan cache, or when `jax`, `jaxlib`,
`flax` or the JAX package were loaded.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import copy  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional  # noqa: E402

import numpy as np  # noqa: E402

from . import spec  # noqa: E402
from .logs import JobLog, captured  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "oarfish_tpu")
CACHE = spec.HERE / ".cache"


class RunError(RuntimeError):
    """A run that may print no result."""


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of `FORBIDDEN`."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def input_reads(cfg: dict) -> int:
    if "cells" in cfg:
        return int(cfg["cells"]) * int(cfg["reads_per_cell"])
    return int(cfg["reads_per_sample"])


def input_seed(sample_seed: int, k: int) -> int:
    """The generator's seed of the k-th sample of the set `sample_seed`."""
    return int(np.random.SeedSequence([sample_seed % 2**63, k])
               .generate_state(1)[0])


def job_order(seed: int, n: int) -> List[int]:
    """The order in which a run's window takes the cell's `n` samples,
    drawn from the run's seed."""
    return np.random.default_rng([seed % 2**63, 5]).permutation(n).tolist()


def keyed(name: str, plan) -> str:
    """A cache directory's name: `name` and a digest of what the inputs
    in it are made from, so that inputs of other sizes never hit."""
    text = json.dumps(plan, sort_keys=True).encode()
    return f"{name}-{hashlib.sha1(text).hexdigest()[:12]}"


def warmup_config(cell: spec.Cell) -> dict:
    cfg = copy.deepcopy(cell.config)
    if "cells" in cfg:
        cfg["cells"] = int(cell.traffic["warmup_cells"])
    else:
        cfg["reads_per_sample"] = int(cell.traffic["warmup_reads"])
    return cfg


def generate(plan: List[dict], parallel: int) -> subprocess.Popen:
    """Start `python -m perfbench.gen` on `plan`."""
    return subprocess.Popen(
        [sys.executable, "-m", "perfbench.gen", json.dumps(plan),
         "--parallel", str(parallel)], cwd=str(spec.ROOT))


def wait(proc: subprocess.Popen) -> None:
    if proc.wait() != 0:
        raise RunError(f"input generation failed ({proc.returncode})")


def complete(bam: Path) -> bool:
    return bam.exists() and Path(str(bam) + ".npz").exists()


@dataclass
class Inputs:
    """The warm-up input and the job inputs, with the generators still
    writing them."""

    warmup: Path
    jobs: List[Path]
    warm_proc: Optional[subprocess.Popen] = None
    jobs_proc: Optional[subprocess.Popen] = None

    def wait_warmup(self) -> None:
        if self.warm_proc is not None:
            wait(self.warm_proc)
            self.warm_proc = None

    def wait_all(self) -> None:
        self.wait_warmup()
        if self.jobs_proc is not None:
            wait(self.jobs_proc)
            self.jobs_proc = None

    def stop(self) -> None:
        for proc in (self.warm_proc, self.jobs_proc):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()


def start_inputs(cell: spec.Cell, cache: Path,
                 sample_seed: int = 0) -> Inputs:
    """The warm-up input and the cell's `inputs` samples (the set
    `sample_seed`: the benchmark's runs all take set 0, so every run does
    the same work), kept in `cache`; what is missing is generated in
    processes of their own."""
    wcfg = warmup_config(cell)
    warm = {"config": wcfg, "seed": 1, "reads": input_reads(wcfg)}
    plans = [{"config": cell.config, "seed": input_seed(sample_seed, k),
              "reads": input_reads(cell.config)}
             for k in range(int(cell.traffic["inputs"]))]
    warm_dir = cache / keyed(cell.name + "-warmup", warm)
    jobs_dir = cache / keyed(cell.name, plans)
    out = Inputs(warm_dir / "in.bam",
                 [jobs_dir / f"in{k}.bam" for k in range(len(plans))])
    if not complete(out.warmup):
        warm_dir.mkdir(parents=True, exist_ok=True)
        out.warm_proc = generate([{**warm, "path": str(out.warmup)}], 1)
    missing = [k for k, p in enumerate(out.jobs) if not complete(p)]
    if missing:
        jobs_dir.mkdir(parents=True, exist_ok=True)
        out.jobs_proc = generate([{**plans[k], "path": str(out.jobs[k])}
                                  for k in missing], len(missing))
    return out


def run_job(cell: spec.Cell, bam: Path, out: Path, cli: List[str],
            device: Optional[str]) -> None:
    """One job through the CLI's normal path, in this process."""
    from oarfish_tpu_torch.cli import build_parser, to_args
    from oarfish_tpu_torch.config import resolve_filters

    argv = ["--alignments", str(bam), "-o", str(out), *cli]
    if device is not None:
        argv += ["--device", device]
    args = to_args(build_parser().parse_args(argv))
    opts = resolve_filters(args)
    if cell.traffic["entry"] == "bulk":
        from oarfish_tpu_torch.quant.bulk import (
            quantify_bulk_alignments_from_bam)

        quantify_bulk_alignments_from_bam(args, opts)
    else:
        from oarfish_tpu_torch.quant.single_cell import (
            quantify_single_cell_from_collated_bam)

        quantify_single_cell_from_collated_bam(args, opts)


@dataclass
class Run:
    """What the metric readers read: the cell, each job's log lines and
    times, and the device trace of a traced run."""

    cell: spec.Cell
    jobs: List[JobLog]
    trace: object = None


def synchronize(device: str) -> None:
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", cache: Path = CACHE,
             stderr=sys.stderr) -> dict:
    """Set-up, the window and the check; returns the result line."""
    from . import check
    from .trace import breakdown, device_busy, profiled

    os.environ["OARFISH_PLAN_CACHE"] = "0"
    inputs = start_inputs(cell, cache)
    order = job_order(seed, len(inputs.jobs))
    cli_device = None if device == "cuda" else device
    work = Path(tempfile.mkdtemp(prefix="perfbench_jobs_"))
    try:
        inputs.wait_warmup()
        t_warm = time.time()
        with captured() as cap:
            cap.job = JobLog(start=t_warm)
            wcli = cell.traffic.get("warmup_cli", cell.traffic["cli"])
            run_job(cell, inputs.warmup, work / "warmup", wcli, cli_device)
            synchronize(device)
        for f in work.glob("warmup.*"):
            f.unlink()
        warm_s = time.time() - t_warm
        inputs.wait_all()
        setup_s = time.time() - T_START
        stderr.write(f"setup: warm-up input at {t_warm - T_START:.3f} s, "
                     f"warm-up job {warm_s:.3f} s, all inputs at "
                     f"{setup_s:.3f} s\n")

        jobs: List[JobLog] = []
        outcomes: List[dict] = []
        reads = input_reads(cell.config)
        done_reads = 0
        # a window holds at least this many whole jobs, so that a slower
        # host runs longer rather than fewer jobs
        min_jobs = int(cell.traffic.get("min_jobs", 1))
        on_card = device.startswith("cuda")
        with profiled(trace, on_card) as prof, captured() as cap:
            w0 = time.time()
            while True:
                now = time.time()
                if len(jobs) >= min_jobs and (
                        (now - w0) * (len(jobs) + 1) / len(jobs) > seconds):
                    break
                k = len(jobs)
                bam = inputs.jobs[order[k % len(order)]]
                job = JobLog(start=now)
                cap.job = job
                ok = True
                try:
                    run_job(cell, bam, work / f"job{k}", cell.traffic["cli"],
                            cli_device)
                    synchronize(device)
                except Exception:  # a failed job is counted, not fatal
                    ok = False
                    stderr.write(traceback.format_exc()[-4000:])
                job.end = time.time()
                cap.job = None
                jobs.append(job)
                outcomes.append({"input": bam, "out": work / f"job{k}",
                                 "ok": ok})
                done_reads += reads if ok else 0
            w1 = time.time()
        hits = [h for job in jobs for h in job.plan_hits()]
        if hits:
            raise RunError(f"a measured job hit the plan cache: {hits[0]}")
        peak_rss_gb = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1e6
        dev = device_info(device)
        loaded = forbidden_modules()
        if loaded:
            raise RunError(f"modules loaded that may not be: {loaded}")

        metrics, extra = {}, {}
        if trace:
            metrics = spec.read_metrics(cell.per_layer,
                                        Run(cell, jobs, prof.trace))
            if prof.trace is not None:
                dev["busy_s"] = device_busy(prof.trace, *prof.trace.window)
                dev["window_s"] = prof.trace.window_s
                if dev["busy_s"] <= 0 and on_card:
                    raise RunError("no operation ran on the device")
                extra["breakdown"] = breakdown(prof.trace, jobs)
        else:
            e2e = {"reads_per_s": done_reads / (w1 - w0),
                   "peak_rss_gb": peak_rss_gb, "setup_s": setup_s}
            metrics = {m["name"]: {"value": e2e[m["name"]],
                                   "unit": m["unit"]}
                       for m in cell.end_to_end if m["name"] in e2e}
        # the program's state goes before the reference runs
        del prof
        gc.collect()
        if on_card:
            import torch

            torch.cuda.empty_cache()
        numbers = check.judge(cell, outcomes, seed, device)
        failed = sum(not o["ok"] for o in outcomes)
        line = {"correct": numbers.correct() and failed == 0,
                "attempted": len(outcomes), "failed": failed,
                "metrics": metrics, "device": dev, **extra,
                "checks": numbers.report()}
        for err in numbers.errors:
            stderr.write(f"check: {err}\n")
        for k, job in enumerate(jobs):
            marks = job.marks()
            spans = [(name, t1 - t0) for (t0, _), (t1, name) in
                     zip([(job.start, "")] + marks[:-1], marks)]
            boot = job.boot()
            steps = (f"; replicate m-steps {sum(boot[2])}, slowest "
                     f"{max(boot[2])}" if boot and boot[2] else "")
            stderr.write(f"job {k}: {job.end - job.start:.3f} s; "
                         + ", ".join(f"{name} {s:.3f}" for name, s in spans)
                         + steps + "\n")
        stderr.write(f"jobs {len(outcomes)}, failed {failed}, window "
                     f"{w1 - w0:.3f} s, setup {setup_s:.3f} s\n")
        for name, v in numbers.report().items():
            stderr.write(f"check {name}: {v['value']} (limit "
                         f"{v['limit']})\n")
        return line
    finally:
        inputs.stop()
        shutil.rmtree(work, ignore_errors=True)


def device_info(device: str) -> dict:
    """The card the run used, and its peak of allocated memory."""
    if not device.startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="perfbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    ns = parse_args(argv)
    cell = spec.load_cell(ns.workload)
    try:
        import oarfish_tpu_torch  # noqa: F401  (the system under test)
    except ImportError as e:
        sys.stderr.write(f"perfbench: the program is missing: {e}\n")
        return 2
    import torch

    chips = int(cell.entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        sys.stderr.write(f"perfbench: the cell {cell.name} needs {chips} "
                         f"CUDA device(s); found "
                         f"{torch.cuda.device_count()}\n")
        return 2
    try:
        line = run_cell(cell, ns.seed, ns.seconds, bool(ns.trace))
    except RunError as e:
        sys.stderr.write(f"perfbench: {e}\n")
        return 3
    # the result line is the last of stdout; the numbers compared are the
    # last lines of stderr
    sys.stdout.write(json.dumps(line) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
