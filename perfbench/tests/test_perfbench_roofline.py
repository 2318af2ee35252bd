"""The least bytes of the EM's work on a CSR counted by hand."""

from perfbench.roofline import csr_bytes, em_least_bytes


def test_hand_counted_csr():
    # 3 reads: {t0}, {t0, t1}, {t1, t2, t0}; 6 alignments, 3 transcripts
    A, R, T = 6, 3, 3
    # a pass: 6 weights and 6 ids of 4 bytes, 4 read offsets of 4 bytes
    assert csr_bytes(A, R) == 6 * 4 + 6 * 4 + 4 * 4 == 64
    # point EM alone, 10 m-steps: the CSR and the abundances (read and
    # written, 3 x 4 bytes each way) each m-step
    assert em_least_bytes(A, R, T, 10, []) == 10 * (64 + 24)
    # and two replicates of 4 and 7 m-steps: the CSR 7 times, each
    # replicate's 3 multiplicities and its abundances per own m-step
    assert em_least_bytes(A, R, T, 10, [4, 7]) == (
        10 * (64 + 24) + 7 * 64 + (4 + 7) * (3 * 4 + 24))
