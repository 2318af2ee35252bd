"""Write the BAMs of a plan: `python -m perfbench.gen PLAN`.

The plan is a JSON text: a list of `{"path", "config", "seed", "reads"}`, the
configuration given whole (a dict) or by name. Each BAM is written
under a temporary name beside its path and moved there when it is
complete, with its records; the BAMs are built one per process, at most
`--parallel` at a time.
"""

from __future__ import annotations

import argparse
import json
import sys
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

from .bam import build_one

def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="perfbench.gen")
    p.add_argument("plan", type=json.loads)
    p.add_argument("--parallel", type=int, default=2)
    ns = p.parse_args(argv)
    plan = ns.plan
    with ProcessPoolExecutor(max(1, min(ns.parallel, len(plan))),
                             mp_context=get_context("spawn")) as pool:
        for item, info in zip(plan, pool.map(build_one, plan)):
            sys.stderr.write(f"perfbench.gen: {item['path']}: "
                             f"{json.dumps(info)}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
