"""Whole runs of the routed v4 EM of the torch port vs the JAX package's,
its NumPy oracle and the port's own CLI, on the uniform CSR of
`test_torch_em_v4.py` (R = 40,000 reads, T = 2,000 transcripts), built
once per module by both packages. The JAX side is reached through
`make_runner`, `run_em_v4_batch` and `run_em_v4_batch_squarem` directly
(its Pallas kernels run in interpret mode on the CPU).

Tolerances, all f32:

* the whole EM: the same number of iterations, counts at rtol 1e-5 /
  atol 1e-3 (the JAX package's own bar for batched vs serial runs);
  against the NumPy f64 oracle L1/R < 2e-3 and total mass within 1e-4.
  The same bar for the batched SQUAREM run against the JAX package's
  `run_em_v4_batch_squarem`. On the card (`cuda`) a batched replicate
  against its serial run: the same iterations and the same bits.
* `.quant` of `--em-impl v4` (f32) against `--em-impl segsum` (f64)
  through the port's CLI: L1 per read < 2e-3, mass within 1e-4.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oarfish_tpu.ops import em_v4 as jv4
from oarfish_tpu_torch.cli import main as torch_main
from oarfish_tpu_torch.ops import bootstrap as tboot
from oarfish_tpu_torch.ops import em_v4 as tv4
from oarfish_tpu_torch.ops.em_oracle import do_em_oracle
from test_torch_em_v4 import R, T, build_case, read_counts
from util_torch import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def cases():
    return {"uniform": build_case("uniform")}


def test_batched_em_matches_jax_batch_runner(cases, monkeypatch):
    """`run_em_v4` on `[B, T]` against the JAX package's `run_em_v4_batch`
    with its in-kernel arm: the same iterations per replicate."""
    c = cases["uniform"]
    monkeypatch.setenv("OARFISH_V4_BATCH_KERNELS", "1")
    rng = np.random.default_rng(16)
    mult = tboot.sample_multiplicities(rng, 3, R)[:, c["torder"]].astype(
        np.float32)
    jax_counts, jax_niter = jv4.run_em_v4_batch(
        c["jd"], jnp.full(T, R / T, dtype=jnp.float32), 56, 5e-3,
        jnp.asarray(mult))
    init = torch.full((3, T), R / T, dtype=torch.float32)
    counts, niter = tv4.run_em_v4(c["td"], init, 56, 5e-3,
                                  multiplicity=torch.from_numpy(mult))
    assert niter.tolist() == np.asarray(jax_niter).tolist()
    np.testing.assert_allclose(counts.numpy(), np.asarray(jax_counts),
                               rtol=1e-5, atol=1e-3)


@pytest.fixture(scope="module")
def em_runs(cases):
    c = cases["uniform"]
    init = torch.full((T,), R / T, dtype=torch.float32)
    counts, niter = tv4.run_em_v4(c["td"], init, 60, 5e-3)
    return c, init, counts, int(niter)


def test_em_matches_jax_runner(em_runs):
    c, _, counts, niter = em_runs
    runner = jv4.make_runner(c["jd"])
    want, jniter = runner(jnp.full(T, R / T, dtype=jnp.float32), 60, 5e-3)
    assert niter == int(jniter) and 50 < niter < 60
    np.testing.assert_allclose(counts.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-3)


def test_em_matches_numpy_oracle(em_runs):
    """15 iterations of both (the f64 oracle is a serial NumPy loop)."""
    c, init, _, _ = em_runs
    txp_id, w, boundaries = c["csr"]
    counts, niter = tv4.run_em_v4(c["td"], init, 15, 5e-3)
    assert int(niter) == 15
    want = do_em_oracle(txp_id, w, boundaries, T, max_iter=15,
                        convergence_thresh=5e-3)
    got = counts.double().numpy()
    assert abs(got.sum() - R) / R < 1e-4
    assert np.abs(got - want).sum() / R < 2e-3


def test_second_run_is_bit_identical(em_runs):
    c, init, counts, niter = em_runs
    again, n2 = tv4.run_em_v4(c["td"], init, 60, 5e-3)
    assert int(n2) == niter and torch.equal(again, counts)


def test_squarem_reaches_the_same_fixed_point(em_runs):
    c, init, counts, _ = em_runs
    sq, n = tv4.run_em_v4_squarem(c["td"], init, 60, 5e-3)
    assert int(n) <= 60
    assert abs(float(sq.double().sum()) - R) / R < 1e-4
    assert float((sq - counts).abs().sum()) / R < 5e-3


def test_bootstraps_equal_serial_runs(cases):
    """`run_replicates` on a pool of 2 slots equals one run per
    replicate, each with its own iteration count."""
    c = cases["uniform"]
    data = c["td"]
    init = torch.full((T,), R / T, dtype=torch.float32)
    rng = np.random.default_rng(15)
    mult = tboot.sample_multiplicities(rng, 3, R)[:, c["torder"]]
    assert mult.shape == (3, data.row_space_r)
    got, niters = tboot.run_replicates(
        tv4.replicate_step(data, 56, 5e-3), mult, init, batch=2)
    assert got.shape == (3, T)
    for b in range(3):
        want, niter = tv4.run_em_v4(
            data, init, 56, 5e-3,
            multiplicity=torch.from_numpy(mult[b]).float())
        assert int(niter) == int(niters[b])
        np.testing.assert_array_equal(got[b], want.double().numpy())
        assert abs(got[b].sum() - R) / R < 1e-4


@pytest.mark.cuda
def test_batched_replicates_on_the_card_match_serial_runs(cases):
    """On the card the kernels give every replicate of a batch the bits of
    a single launch, and the glue's row sums (`ops/row_sums.py`) add each
    row in a fixed order whatever the batch, so a replicate's counts do
    not depend on its batch: the same iterations as the serial run and the
    same bits (f32, up to 200 iterations), whatever the pool (3 slots, or
    2, the third replicate taking the first slot freed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = cases["uniform"]
    txp_id, w, boundaries = c["csr"]
    data, order = tv4.EmV4Data.build(txp_id, w, boundaries, T, device="cuda")
    np.testing.assert_array_equal(order, c["torder"])
    init = torch.full((T,), R / T, dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(19)
    mult = tboot.sample_multiplicities(rng, 3, R)[:, order]

    def run(i, m):
        return tv4.run_em_v4(data, i, 200, 1e-3, multiplicity=m)

    serial = [run(init, torch.from_numpy(mult[b]).float().cuda())
              for b in range(3)]
    for batch in (3, 2):
        got, niters = tboot.run_replicates(
            tv4.replicate_step(data, 200, 1e-3), mult, init, batch=batch)
        for b, (want, niter) in enumerate(serial):
            assert int(niters[b]) == int(niter) > 50, (batch, b)
            np.testing.assert_array_equal(
                got[b], want.double().cpu().numpy(), err_msg=f"{batch} {b}")
            assert abs(got[b].sum() - R) / R < 1e-4


def test_squarem_batch_equals_serial_runs(cases):
    """`run_em_v4_squarem` on `[B, T]` (the counterpart of
    `run_em_v4_batch_squarem`) against one accelerated run per replicate:
    the same iterations; values at rtol 1e-5 (the step length is a ratio of
    two dot products over T, which a batch sums in another order, and it
    reaches 64)."""
    c = cases["uniform"]
    data = c["td"]
    rng = np.random.default_rng(17)
    mult = torch.from_numpy(tboot.sample_multiplicities(rng, 2, R)[
        :, c["torder"]].astype(np.float32))
    init = torch.full((2, T), R / T, dtype=torch.float32)
    got, niters = tv4.run_em_v4_squarem(data, init, 30, 5e-3,
                                        multiplicity=mult)
    assert got.shape == (2, T)
    for b in range(2):
        want, niter = tv4.run_em_v4_squarem(data, init[b], 30, 5e-3,
                                            multiplicity=mult[b])
        assert int(niter) == int(niters[b]) == 30
        np.testing.assert_allclose(got[b].numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-3)
        assert abs(float(got[b].double().sum()) - R) / R < 1e-4


def test_squarem_batch_matches_jax_batch_runner(cases, monkeypatch):
    """`run_em_v4_squarem` on `[B, T]` against the JAX package's
    `run_em_v4_batch_squarem` with its in-kernel arm, on the carried
    tables: the same iterations per replicate, counts at the whole EM's
    rtol 1e-5 / atol 1e-3."""
    c = cases["uniform"]
    monkeypatch.setenv("OARFISH_V4_BATCH_KERNELS", "1")
    rng = np.random.default_rng(18)
    mult = tboot.sample_multiplicities(rng, 3, R)[:, c["jorder"]].astype(
        np.float32)
    jax_counts, jax_niter = jv4.run_em_v4_batch_squarem(
        c["jd"], jnp.full(T, R / T, dtype=jnp.float32), 30, 5e-3,
        jnp.asarray(mult))
    init = torch.full((3, T), R / T, dtype=torch.float32)
    counts, niter = tv4.run_em_v4_squarem(
        c["carried"], init, 30, 5e-3, multiplicity=torch.from_numpy(mult))
    assert niter.tolist() == np.asarray(jax_niter).tolist()
    got = counts.numpy()
    assert got.shape == (3, T)
    np.testing.assert_allclose(got, np.asarray(jax_counts)[:, :T],
                               rtol=1e-5, atol=1e-3)
    assert (np.abs(got.astype(np.float64).sum(axis=1) - R) / R < 1e-4).all()



def test_cli_v4_matches_segsum(tmp_path, caplog):
    """A BAM of the same size through the port's CLI on the CPU."""
    from chip_smoke import build_e2e_bam

    bam = tmp_path / "v4.bam"
    build_e2e_bam(bam, R, T, seed=3, threads=2)
    base = ["--alignments", str(bam), "--device", "cpu", "--num-bootstraps",
            "2", "--seed", "1"]
    with caplog.at_level(logging.INFO, logger="oarfish_tpu_torch"):
        assert torch_main(base + ["--em-impl", "v4", "-o",
                                  str(tmp_path / "v4")]) == 0
    assert "v4 EM on cpu (float32)" in caplog.text
    assert "--em-impl v4 runs in float32" in caplog.text
    assert torch_main(base + ["--em-impl", "segsum", "--quiet", "-o",
                              str(tmp_path / "seg")]) == 0
    got = read_counts(str(tmp_path / "v4") + ".quant")
    want = read_counts(str(tmp_path / "seg") + ".quant")
    kept = want.sum()
    assert got.shape == (T,) and kept > 0.9 * R
    assert abs(got.sum() - kept) / kept < 1e-4
    assert np.abs(got - want).sum() / kept < 2e-3
    import pyarrow.parquet as pq

    reps = [pq.read_table(str(tmp_path / tag) + ".infreps.pq")
            for tag in ("v4", "seg")]
    a, b = (np.stack([np.asarray(t[c]) for c in t.column_names])
            for t in reps)
    assert a.shape == b.shape == (2, T)
    # the same draw reaches the same reads through the layout's row order
    assert np.abs(a - b).sum(axis=1).max() / kept < 2e-3
