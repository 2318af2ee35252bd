"""The readings that the limits of `check.py` are set from, at a cell's
own size, in one process:

    python3 -m perfbench.calibrate --workload NAME --seeds 11-22 \
        [--control 3] [--out FILE] [--device cuda] [--cache DIR]

For each seed: a sample made from the seed (not the cell's fixed set, so
that the readings cover inputs that differ), one job of the program
through the CLI's normal path with the seed as the CLI's `--seed` (so
that the replicates' draw differs too), after the same warm-up as a run,
and the job's files judged against the reference by `check.judge` (the
program's readings, the lower ones). For the first `--control` seeds
also the control: the same job with the reference computed in bfloat16,
the precision below the configuration's float32, put in the program's
place where the job writes its answers, and judged by the same
`check.judge` (the upper readings). One JSON line a seed to stdout and,
with `--out`, to FILE. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from . import check, run, spec


@contextlib.contextmanager
def in_programs_place(cell: spec.Cell, bam: Path, seed: int, device,
                      dtype):
    """The reference in `dtype` put in the program's place: while this
    holds, a job writes the reference's answers for `bam` where it would
    write its own (the point EM, the checked replicates, the matrix).
    Answers of another size, such as the warm-up's, pass unchanged."""
    if cell.traffic["entry"] == "bulk":
        import oarfish_tpu_torch.quant.bulk as module

        num_boot, boot_seed, checked = check.boot_settings(cell)
        sample = check.replicate_sample(seed, num_boot, checked)
        exp = check.BulkExpected(bam, num_boot,
                                 check.drawer(num_boot, boot_seed, sample),
                                 sample, device, dtype)
        write_out, write_reps = module.write_output, module.write_infrep_file

        def write_output(output, info, names, lens, counts, *rest):
            if len(counts) == len(exp.counts):
                counts = exp.counts
            return write_out(output, info, names, lens, counts, *rest)

        def write_infrep_file(output, breps):
            breps = np.array(breps, dtype=np.float64)
            if len(breps) == num_boot:
                for i, counts in exp.boot.items():
                    breps[i] = counts
            return write_reps(output, breps)

        patches = {"write_output": write_output,
                   "write_infrep_file": write_infrep_file}
    else:
        import oarfish_tpu_torch.quant.single_cell as module

        exp = check.ScExpected(bam, device, dtype)
        write_sc = module.write_single_cell_output

        def write_single_cell_output(output, info, names, barcodes, rows,
                                     cols, vals, num_rows):
            if num_rows == exp.cells:
                rows, cols, vals = exp.keys // exp.T, exp.keys % exp.T, \
                    exp.vals
            return write_sc(output, info, names, barcodes, rows, cols, vals,
                            num_rows)

        patches = {"write_single_cell_output": write_single_cell_output}
    saved = {name: getattr(module, name) for name in patches}
    try:
        for name, fn in patches.items():
            setattr(module, name, fn)
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def job_numbers(cell: spec.Cell, bam: Path, out: Path, seed: int,
                device: str) -> tuple:
    """One job of `cell` on `bam`, judged: (seconds, `check.Numbers`)."""
    import torch

    t0 = time.time()
    ok = True
    try:
        run.run_job(cell, bam, out, cell.traffic["cli"],
                    None if device == "cuda" else device)
        run.synchronize(device)
    except Exception as e:  # a failed job is a reading too
        ok = False
        sys.stderr.write(f"seed {seed}: the job raised {e!r}\n")
    wall = time.time() - t0
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    numbers = check.judge(cell, [{"input": bam, "out": out, "ok": ok}],
                          seed, device)
    for f in out.parent.glob(out.name + ".*"):
        f.unlink()
    return wall, numbers


def seeds_of(text: str):
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="perfbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds_of, required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--out", type=Path)
    p.add_argument("--device", default="cuda")
    p.add_argument("--cache", type=Path, default=run.CACHE)
    ns = p.parse_args(argv)
    import torch

    if ns.device == "cuda" and not torch.cuda.is_available():
        sys.stderr.write("perfbench.calibrate: no CUDA device\n")
        return 2
    cell = spec.load_cell(ns.workload)
    work = Path(tempfile.mkdtemp(prefix="perfbench_cal_"))
    fh = open(ns.out, "a") if ns.out else None
    pending = None
    try:
        os.environ["OARFISH_PLAN_CACHE"] = "0"
        one = copy.deepcopy(cell)
        one.traffic["inputs"] = 1

        def start(seed):
            return run.start_inputs(one, ns.cache, sample_seed=seed)

        pending = start(ns.seeds[0])
        for k, seed in enumerate(ns.seeds):
            inputs = pending
            inputs.wait_all()
            # the next seed's sample is made while this one is judged
            pending = start(ns.seeds[k + 1]) if k + 1 < len(ns.seeds) else None
            if k == 0:
                run.run_job(one, inputs.warmup, work / "warmup",
                            one.traffic.get("warmup_cli",
                                            one.traffic["cli"]),
                            None if ns.device == "cuda" else ns.device)
            bam = inputs.jobs[0]
            seeded = copy.deepcopy(one)
            seeded.traffic["cli"] = [*one.traffic["cli"], "--seed",
                                     str(seed)]
            wall, numbers = job_numbers(seeded, bam, work / "job", seed,
                                        ns.device)
            line = {"workload": cell.name, "seed": seed, "job_s": wall,
                    "program": numbers.values, "errors": numbers.errors}
            if k < ns.control:
                with in_programs_place(seeded, bam, seed, ns.device,
                                       torch.bfloat16):
                    _, control = job_numbers(seeded, bam, work / "job",
                                             seed, ns.device)
                line["control_bf16"] = control.values
                line["control_correct"] = control.correct()
            shutil.rmtree(bam.parent, ignore_errors=True)
            text = json.dumps(line)
            print(text, flush=True)
            if fh:
                fh.write(text + "\n")
                fh.flush()
    finally:
        if pending is not None:
            pending.stop()
        if fh:
            fh.close()
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
