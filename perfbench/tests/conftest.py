"""The benchmark's CPU tests: `python -m pytest perfbench/tests`. Tests
marked `cuda` need the card and skip without one; they decide inside the
test."""

import copy

import pytest

from perfbench import spec


# a single-cell cell at a test run's size: the harness keeps the
# single-cell path (`entry: single_cell`, `check.ScExpected`, the readers
# `ingest_s.sc` and `sc_em_s`) for a cell that `BENCHMARK.json` does not
# name yet
SC_CONFIG = {"mode": "single_cell", "transcripts": 500, "txp_len_min": 400,
             "txp_len_max": 4000, "cells": 20, "reads_per_cell": 30,
             "barcode_len": 16, "mean_alignments_per_read": 2,
             "max_alignments_per_read": 20, "zipf_a": 1.3, "span_min": 200,
             "span_max": 380, "score_drop_max": 10, "reduced": []}
SC_TRAFFIC = {"name": "sc-tiny", "entry": "single_cell",
              "cli": ["--single-cell", "--threads", "2"], "inputs": 2,
              "warmup_cells": 4,
              "limits": {"cells_gap": 0, "matrix_l1": 5e-05}}
SC_PER_LAYER = [{"name": n, "unit": u, "better": "lower",
                 "moves": "reads_per_s"}
                for n, u in (("ingest_s.sc", "s"), ("sc_em_s", "s"),
                             ("device_idle_pct", "%"))]


def tiny(name: str) -> spec.Cell:
    """A cell at a size a test run holds: `bulk-boot100` with 500
    transcripts, 3,000 reads a sample, two samples a run and 10
    replicates (all of them checked); `sc`, 20 cells x 30 reads a
    library over 500 transcripts."""
    if name == "sc":
        bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
        return spec.Cell(name="sc-tiny", entry={"name": "sc-tiny",
                                                 "chips": 1},
                         config=copy.deepcopy(SC_CONFIG),
                         traffic=copy.deepcopy(SC_TRAFFIC),
                         end_to_end=bench["end_to_end"],
                         per_layer=copy.deepcopy(SC_PER_LAYER))
    cell = spec.load_cell(name)
    cfg, tr = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    cfg["transcripts"] = 500
    cfg["reads_per_sample"] = 3000
    tr["inputs"], tr["min_jobs"] = 2, 1
    tr["warmup_reads"] = 1000
    tr["cli"] = ["--num-bootstraps", "10", "--threads", "2"]
    tr["warmup_cli"] = ["--num-bootstraps", "2", "--threads", "2"]
    tr["check_replicates"] = 10
    cell.config, cell.traffic = cfg, tr
    return cell


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device")


@pytest.fixture
def need_cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
