"""The frozen generators: the same bytes for one seed, other bytes for
another, and the bytes of the program's generators they were copied from
at those generators' constants."""

import hashlib

import numpy as np
import pytest

from perfbench import run
from perfbench.gen.bam import build_bam

from .conftest import tiny

BULK = {"transcripts": 300, "txp_len_min": 2200, "txp_len_max": 12000,
        "mean_alignments_per_read": 3, "max_alignments_per_read": 50,
        "zipf_a": 1.3, "span_min": 400, "span_max": 2000,
        "score_drop_max": 20}
SC = {"transcripts": 200, "txp_len_min": 400, "txp_len_max": 4000,
      "cells": 12, "reads_per_cell": 20, "barcode_len": 16,
      "mean_alignments_per_read": 2, "max_alignments_per_read": 20,
      "zipf_a": 1.3, "span_min": 200, "span_max": 380, "score_drop_max": 10}


def digest(path) -> str:
    return hashlib.blake2b(path.read_bytes()).hexdigest()


@pytest.mark.parametrize("cfg,reads", [(BULK, 700), (SC, 240)],
                         ids=["bulk", "single_cell"])
def test_one_seed_one_input(tmp_path, cfg, reads):
    a, b, c = (tmp_path / f"{n}.bam" for n in "abc")
    build_bam(a, cfg, 5, reads, chunk_reads=200)
    build_bam(b, cfg, 5, reads, chunk_reads=200)
    build_bam(c, cfg, 6, reads, chunk_reads=200)
    assert digest(a) == digest(b) != digest(c)
    ra, rc = np.load(str(a) + ".npz"), np.load(str(c) + ".npz")
    assert len(ra["sizes"]) == reads == len(ra["seq_len"])
    assert ra["sizes"].sum() == len(ra["tid"]) == len(ra["score"])
    assert not np.array_equal(ra["tid"][:50], rc["tid"][:50])


def test_bulk_bytes_are_the_programs(tmp_path):
    from oarfish_tpu_torch.bench import build_e2e_bam

    build_bam(tmp_path / "a.bam", BULK, 3, 900, chunk_reads=250)
    build_e2e_bam(tmp_path / "b.bam", 900, 300, seed=3, chunk_reads=250)
    assert digest(tmp_path / "a.bam") == digest(tmp_path / "b.bam")


def test_single_cell_bytes_are_the_programs(tmp_path):
    from oarfish_tpu_torch.bench_modes import build_sc_bam

    build_bam(tmp_path / "a.bam", SC, 4, 240, chunk_reads=100)
    build_sc_bam(tmp_path / "b.bam", 12, 20, 200, seed=4, chunk_reads=100)
    assert digest(tmp_path / "a.bam") == digest(tmp_path / "b.bam")


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
def test_the_seed_orders_the_samples(seed):
    order = run.job_order(seed, 4)
    assert sorted(order) == [0, 1, 2, 3]
    assert order == run.job_order(seed, 4)
    assert len({tuple(run.job_order(seed + d, 4)) for d in range(8)}) > 1


@pytest.mark.parametrize("name", ["bulk-boot100", "sc"])
def test_inputs_are_made_once_and_kept_by_what_makes_them(tmp_path, name):
    """Every run takes the cell's one set of samples, made once; a set of
    another size or seed goes to a directory of its own."""
    cell = tiny(name)
    first = run.start_inputs(cell, tmp_path)
    assert first.jobs_proc is not None and first.warm_proc is not None
    first.wait_all()
    again = run.start_inputs(cell, tmp_path)
    assert again.jobs == first.jobs and again.warmup == first.warmup
    assert again.jobs_proc is None and again.warm_proc is None
    assert len({digest(p) for p in first.jobs}) == len(first.jobs)
    other = run.start_inputs(cell, tmp_path, sample_seed=3)
    assert other.warm_proc is None and other.jobs_proc is not None
    other.wait_all()
    assert other.jobs[0].parent != first.jobs[0].parent
    assert digest(other.jobs[0]) != digest(first.jobs[0])
