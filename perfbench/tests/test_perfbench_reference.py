"""The plain reference on cases worked by hand."""

import numpy as np
import pytest
import torch

from perfbench.reference import em as ref_em
from perfbench.reference.filters import aux_counts, filter_records


def records(reads):
    """Generator-style arrays from [(seq_len, [(tid, span, score)...])]."""
    out = {k: [] for k in ("tid", "pos", "span", "score")}
    for _, alns in reads:
        for tid, span, score in alns:
            out["tid"].append(tid)
            out["pos"].append(10)
            out["span"].append(span)
            out["score"].append(score)
    rec = {k: np.asarray(v) for k, v in out.items()}
    rec["sizes"] = np.array([len(a) for _, a in reads])
    rec["seq_len"] = np.array([s for s, _ in reads])
    rec["t_len"] = np.full(3, 5000)
    return rec


def test_filters_by_hand():
    kept = filter_records(records([
        (1021, [(0, 1000, 990), (1, 1000, 950), (2, 1000, 930)]),
        (1021, [(1, 40, 40)]),  # too short: dropped, no valid alignment
        (3000, [(2, 1000, 1000)]),  # aligned fraction 1/3: dropped
        (521, [(2, 500, 500), (0, 500, 480)]),
    ]))
    # read 0 keeps 990 and 950 (950/990 >= 0.95), not 930
    assert kept.valid_best_aln == 2 and kept.num_reads == 2
    assert kept.txp_id.tolist() == [0, 1, 2, 0]
    assert kept.read_offsets.tolist() == [0, 2, 4]
    assert kept.discard_score == 1
    np.testing.assert_array_equal(
        kept.prob, np.exp(np.float32([0, -40, 0, -20]) / np.float32(5)))
    unique, total = aux_counts(kept, 3)
    assert total.tolist() == [2, 1, 1] and unique.tolist() == [0, 0, 0]


def csr(alns, T):
    """alns: one list of transcripts per read, weights 1."""
    slot = np.concatenate([np.asarray(a) for a in alns])
    read = np.repeat(np.arange(len(alns)), [len(a) for a in alns])
    return ref_em.Csr(slot, np.ones(len(slot)), read, len(alns), T,
                      np.zeros(T, np.int64), 1, "cpu", torch.float64)


def test_em_by_hand():
    # two reads on t0 alone, one shared: t1's share a1 -> a1 / (a0 + a1)
    # shrinks by a third each m-step, falls under 1e-5, is zeroed, and
    # t0 takes all three reads
    c = csr([[0], [0], [0, 1]], 2)
    counts, steps = ref_em.run_em(c, torch.full((1, 2), 1.5,
                                                dtype=torch.float64))
    assert counts[0].tolist() == pytest.approx([3.0, 0.0], abs=1e-12)
    assert int(steps[0, 0]) == 52  # stops at the first test after 50
    # a symmetric case sits at its fixed point
    c = csr([[0], [1], [0, 1]], 2)
    counts, _ = ref_em.run_em(c, torch.full((1, 2), 1.5,
                                            dtype=torch.float64))
    assert counts[0].tolist() == pytest.approx([1.5, 1.5])


def test_multiplicities_weight_reads():
    # read 0 (t0) twice, read 1 (t1) never, read 2 (shared) once:
    # a0 = 2 + a0/(a0+a1), a1 = a1/(a0+a1) -> t0 takes all 3
    c = csr([[0], [1], [0, 1]], 2)
    m = torch.tensor([[2.0, 0.0, 1.0], [1.0, 1.0, 1.0]],
                     dtype=torch.float64)
    counts, steps = ref_em.run_em(
        c, torch.full((2, 2), 1.5, dtype=torch.float64), mult=m)
    assert counts[0].tolist() == pytest.approx([3.0, 0.0], abs=1e-9)
    assert counts[1].tolist() == pytest.approx([1.5, 1.5])
    # each replicate stops on its own
    assert int(steps[1, 0]) == 52


def test_draw_is_numpys_multinomial():
    m = ref_em.bootstrap_multiplicities(1000, 5, seed=0)
    assert m.shape == (5, 1000) and (m.sum(axis=1) == 1000).all()
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        m, rng.multinomial(1000, np.full(1000, 1 / 1000), size=5))


def test_cells_run_on_their_own():
    # cell 0: reads {t5}, {t5, t7}; cell 1: reads {t7}, {t7}; cell 2: none
    class Kept:
        txp_id = np.array([5, 5, 7, 7, 7])
        prob = np.ones(5, np.float32)
        read_offsets = np.array([0, 1, 3, 4, 5])
        read_of_record = np.array([0, 1, 1, 2, 3])
        num_reads = 4

    cell_of_read = np.array([0, 0, 1, 1])
    c, txp, cell, kept_reads = ref_em.cells_csr(Kept, cell_of_read, 3, 10,
                                                "cpu", torch.float64)
    assert txp.tolist() == [5, 7, 7] and cell.tolist() == [0, 0, 1]
    assert kept_reads.tolist() == [2, 2, 0]
    init = torch.as_tensor(kept_reads[cell] / 10.0)[None]
    counts, steps = ref_em.run_em(c, init)
    assert counts[0].tolist() == pytest.approx([2.0, 0.0, 2.0], abs=1e-9)
    assert steps[0].tolist()[2] == 0  # the empty cell never runs
