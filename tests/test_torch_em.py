"""Segment-sum EM of the torch port vs the JAX package and the NumPy oracle.

f64 on the CPU, the shapes of `tests/test_em.py`. Both packages add each
segment's terms in index order, so results agree to rtol 1e-12 (the
SQUAREM extrapolation takes two full-vector dot products whose order of
additions differs between the frameworks; its atol is 1e-9 on counts of
order 10). Iteration counts must be equal, per replicate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oarfish_tpu.ops import bootstrap as jboot
from oarfish_tpu.ops import em as jem
from oarfish_tpu.ops.em_oracle import do_em_oracle, m_step_oracle
from oarfish_tpu_torch.ops import bootstrap as tboot
from oarfish_tpu_torch.ops import em as tem
from oarfish_tpu_torch.ops import em_oracle as toracle
from oarfish_tpu_torch.ops.convert import em_data_from_numpy
from util_torch import one_torch_thread  # noqa: F401 (autouse fixture)

F64 = torch.float64


def random_csr(rng, R=300, T=40, max_k=8):
    sizes = rng.integers(1, max_k + 1, size=R)
    A = int(sizes.sum())
    boundaries = np.zeros(R + 1, dtype=np.int64)
    np.cumsum(sizes, out=boundaries[1:])
    txp_id = rng.integers(0, T, size=A).astype(np.int32)
    w = np.exp(rng.normal(0, 1, size=A)).astype(np.float64)
    read_id = np.repeat(np.arange(R, dtype=np.int32), sizes)
    return txp_id, w, boundaries, read_id, R, T


SHAPES = [(0, 300, 40, 8), (1, 1500, 200, 30), (2, 50, 10, 3)]


def both(seed, R, T, max_k):
    rng = np.random.default_rng(seed)
    txp_id, w, boundaries, read_id, R, T = random_csr(rng, R, T, max_k)
    jd = jem.EmData.build(txp_id, w, read_id, R, T, dtype=jnp.float64)
    td = tem.EmData.build(txp_id, w, read_id, R, T, dtype=F64, device="cpu")
    return rng, (txp_id, w, boundaries), jd, td


def test_build_equals_jax_and_convert_round_trip():
    _, _, jd, td = both(0, 300, 40, 8)
    fields = ("txp_id", "weights", "read_id", "txp_sort_perm", "txp_id_sorted")
    for f in fields:
        np.testing.assert_array_equal(
            getattr(td, f).numpy(), np.asarray(getattr(jd, f)), err_msg=f)
    cd = em_data_from_numpy(
        *(np.asarray(getattr(jd, f)) for f in fields),
        jd.num_reads, jd.num_txps, F64, "cpu",
    )
    for f in fields + ("read_offsets", "txp_offsets"):
        assert torch.equal(getattr(cd, f), getattr(td, f)), f
        assert getattr(cd, f).dtype == getattr(td, f).dtype, f
    assert (cd.num_reads, cd.num_txps) == (td.num_reads, td.num_txps)


@pytest.mark.parametrize("seed,R,T,max_k", SHAPES)
def test_m_step_matches_jax_and_oracle(seed, R, T, max_k):
    rng, (txp_id, w, boundaries), jd, td = both(seed, R, T, max_k)
    prev = np.exp(rng.normal(0, 1, size=T))
    got = tem._m_step(td, torch.from_numpy(prev), None).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jem._m_step(jd, jnp.asarray(prev), None)), rtol=1e-12)
    np.testing.assert_allclose(
        got, m_step_oracle(txp_id, w, boundaries, prev), rtol=1e-12)
    # the port's own copy of the oracle is the same code
    np.testing.assert_array_equal(
        toracle.m_step_oracle(txp_id, w, boundaries, prev),
        m_step_oracle(txp_id, w, boundaries, prev))


@pytest.mark.parametrize("seed,R,T,max_k", SHAPES)
def test_m_step_batched_equals_unbatched(seed, R, T, max_k):
    rng, _, _, td = both(seed, R, T, max_k)
    prev = torch.from_numpy(np.exp(rng.normal(0, 1, size=(4, T))))
    mult = torch.from_numpy(
        rng.multinomial(R, np.full(R, 1 / R), size=4).astype(np.float64))
    got = tem._m_step(td, prev, mult)
    for b in range(4):
        assert torch.equal(got[b], tem._m_step(td, prev[b], mult[b]))


@pytest.mark.parametrize("B", [1, 3, 8])
def test_flat_batch_equals_single_runs(B, monkeypatch):
    """A batch runs as `[B, A_pad]` flattened with shifted offsets: each
    replicate's m-step and whole EM have the bits and iterations of its
    run alone, and a batched loop makes that layout once."""
    rng, _, _, td = both(1, 1500, 200, 30)
    prev = torch.from_numpy(np.exp(rng.normal(0, 1, size=(B, 200))))
    mult = torch.from_numpy(
        rng.multinomial(1500, np.full(1500, 1 / 1500), size=B)
        .astype(np.float64))
    step = tem._m_step(td, prev, mult)
    init = tem.uniform_init(td, F64)
    built = []
    build = tem.BatchSegments.build
    monkeypatch.setattr(tem.BatchSegments, "build", staticmethod(
        lambda data, n: built.append(n) or build(data, n)))
    counts, niter = tem.run_em(td, init.expand(B, -1), 200, 1e-3,
                               multiplicity=mult)
    assert built == [B] and int(niter.max()) > 50  # once for every m-step
    for b in range(B):
        assert torch.equal(step[b], tem._m_step(td, prev[b], mult[b]))
        one, n_one = tem.run_em(td, init, 200, 1e-3, multiplicity=mult[b])
        assert torch.equal(counts[b], one) and int(niter[b]) == int(n_one)
    assert built == [B]  # single runs make none


def test_bootstrap_equals_single_runs():
    """`bootstrap` (what process 0 of a multi-process run calls) gives 8
    replicates in one batch with the bits of 8 single `run_em` calls with
    the same multiplicities."""
    _, _, _, td = both(0, 300, 40, 8)
    got = tboot.bootstrap(td, 8, max_iter=120, seed=9)
    mult = tboot.sample_multiplicities(np.random.default_rng(9), 8, 300)
    init = tem.uniform_init(td, F64)
    for b in range(8):
        one, _ = tem.run_em(td, init, 120, 1e-3,
                            multiplicity=torch.from_numpy(mult[b]))
        np.testing.assert_array_equal(got[b], one.numpy())


@pytest.mark.parametrize("seed,R,T,max_k", SHAPES)
def test_run_em_matches_jax(seed, R, T, max_k):
    _, (txp_id, w, boundaries), jd, td = both(seed, R, T, max_k)
    cj, nj = jem.run_em(jd, jem.uniform_init(jd, jnp.float64), 200, 1e-3)
    ct, nt = tem.run_em(td, tem.uniform_init(td, F64), 200, 1e-3)
    assert int(nt) == int(nj)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-12)
    want = do_em_oracle(txp_id, w, boundaries, T, max_iter=200,
                        convergence_thresh=1e-3)
    np.testing.assert_allclose(ct.numpy(), want, rtol=1e-9, atol=1e-9)
    assert float(ct.sum()) == pytest.approx(R, rel=1e-9)


@pytest.mark.parametrize("max_iter", [1, 3, 51, 52, 60])
def test_run_em_iteration_cap_matches_jax(max_iter):
    # around min_iters=50: the guard `niter > 50` is read before the
    # increment, so the earliest stop is after 52 steps
    _, _, jd, td = both(0, 300, 40, 8)
    cj, nj = jem.run_em(jd, jem.uniform_init(jd, jnp.float64), max_iter, 1e-1)
    ct, nt = tem.run_em(td, tem.uniform_init(td, F64), max_iter, 1e-1)
    assert int(nt) == int(nj) == min(max_iter, 52)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-12)


@pytest.mark.parametrize("seed,R,T,max_k", SHAPES)
def test_run_em_squarem_matches_jax(seed, R, T, max_k):
    _, _, jd, td = both(seed, R, T, max_k)
    cj, nj = jem.run_em_squarem(
        jd, jem.uniform_init(jd, jnp.float64), 200, 1e-3)
    ct, nt = tem.run_em_squarem(td, tem.uniform_init(td, F64), 200, 1e-3)
    assert int(nt) == int(nj)
    np.testing.assert_allclose(
        ct.numpy(), np.asarray(cj), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("accel", ["none", "squarem"])
def test_em_convenience_entry_matches_jax(accel):
    rng, _, jd, td = both(3, 300, 40, 8)
    init = np.abs(rng.normal(10, 3, size=40))
    cj, nj = jem.em(jd, max_iter=100, init_abundances=init,
                    dtype=jnp.float64, accel=accel)
    ct, nt = tem.em(td, max_iter=100, init_abundances=init, accel=accel)
    assert nt == nj and ct.dtype == np.float64
    np.testing.assert_allclose(ct, cj, rtol=1e-9, atol=1e-9)


def test_em_denominator_guard():
    # one read with all-zero weights must be dropped (denom <= 1e-30)
    txp_id = np.array([0, 1, 0], dtype=np.int32)
    w = np.array([0.0, 0.0, 1.0])
    boundaries = np.array([0, 2, 3], dtype=np.int64)
    read_id = np.array([0, 0, 1], dtype=np.int32)
    data = tem.EmData.build(txp_id, w, read_id, 2, 2, dtype=F64, device="cpu")
    counts, _ = tem.em(data, max_iter=60)
    np.testing.assert_allclose(
        counts, do_em_oracle(txp_id, w, boundaries, 2, max_iter=60))
    assert counts.sum() == pytest.approx(1.0)


@pytest.mark.parametrize("accel", ["none", "squarem"])
@pytest.mark.parametrize("seed,R,T,max_k", SHAPES[:2])
def test_bootstrap_matches_jax(seed, R, T, max_k, accel):
    _, _, jd, td = both(seed, R, T, max_k)
    bj = jboot.bootstrap(jd, 5, max_iter=120, dtype=jnp.float64, seed=7,
                         accel=accel)
    bt = tboot.bootstrap(td, 5, max_iter=120, seed=7, accel=accel)
    assert bt.shape == (5, T) and bt.dtype == np.float64
    np.testing.assert_allclose(bt, bj, rtol=1e-9, atol=1e-9)


def test_bootstrap_batching_does_not_change_replicates(monkeypatch):
    _, _, _, td = both(0, 300, 40, 8)
    whole = tboot.bootstrap(td, 5, max_iter=120, seed=3)
    monkeypatch.setattr(tboot, "BOOT_BATCH", 2)
    mult = tboot.sample_multiplicities(np.random.default_rng(3), 5, 300)
    init = tem.uniform_init(td, F64)
    parts, niters = tboot.run_replicates(
        tem.replicate_step(td, 120, 1e-3), mult, init, batch=2)
    np.testing.assert_array_equal(parts, whole)
    assert niters.shape == (5,) and (niters > 50).all()


def test_sample_multiplicities_same_draw_as_jax():
    a = jboot.sample_multiplicities(np.random.default_rng(11), 4, 500)
    b = tboot.sample_multiplicities(np.random.default_rng(11), 4, 500)
    np.testing.assert_array_equal(a, b)
    assert (b.sum(axis=1) == 500).all()


@pytest.mark.parametrize("squarem", [False, True])
def test_per_replicate_niter_equal_to_jax(squarem):
    """Replicates stop at their own iteration: the batched loop's niter
    vector equals the JAX package's vmapped one. In the plain loop some
    replicates here converge and others run into the cap of 600."""
    _, _, jd, td = both(1, 1500, 200, 30)
    mult = jboot.sample_multiplicities(np.random.default_rng(5), 6, 1500)
    jrun = jem.run_em_squarem if squarem else jem.run_em
    trun = tem.run_em_squarem if squarem else tem.run_em
    init_j = jem.uniform_init(jd, jnp.float64)
    cj, nj = jax.vmap(
        lambda m: jrun(jd, init_j, 600, 1e-5, multiplicity=m)
    )(jnp.asarray(mult))
    init_t = tem.uniform_init(td, F64).expand(6, -1)
    ct, nt = trun(td, init_t, 600, 1e-5, multiplicity=torch.from_numpy(mult))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert len(set(nt.tolist())) > 1, "pick a case where replicates differ"
    # SQUAREM multiplies the step by up to 64, which also multiplies the
    # rounding difference of its two dot products along flat directions
    # of the likelihood; over ~30 cycles that reaches 1e-8 on a few counts
    tol = 1e-6 if squarem else 1e-9
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_segsum_em_bit_reproducible_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    txp_id, w, _, read_id, R, T = random_csr(rng, 20000, 500, 6)
    data = tem.EmData.build(txp_id, w, read_id, R, T,
                            dtype=torch.float32, device="cuda")
    a, na = tem.run_em(data, tem.uniform_init(data, torch.float32), 100, 1e-3)
    b, nb = tem.run_em(data, tem.uniform_init(data, torch.float32), 100, 1e-3)
    assert torch.equal(a, b) and int(na) == int(nb)


@pytest.mark.cuda
def test_segsum_batch_equals_serial_runs_on_card():
    """On the card, with one transcript holding a quarter of the
    alignments (the bench CSR's zipf head), replicate b of a batch of 8 has
    the iterations and bits of its serial run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(4)
    txp_id, w, _, read_id, R, T = random_csr(rng, 20_001, 500, 6)
    txp_id[rng.random(len(txp_id)) < 0.25] = 0
    data = tem.EmData.build(txp_id, w, read_id, R, T,
                            dtype=torch.float32, device="cuda")
    mult = torch.as_tensor(tboot.sample_multiplicities(rng, 8, R),
                           device="cuda").float()
    init = tem.uniform_init(data, torch.float32)
    counts, niter = tem.run_em(data, init.expand(8, -1), 300, 1e-3,
                               multiplicity=mult)
    for b in range(8):
        one, n_one = tem.run_em(data, init, 300, 1e-3, multiplicity=mult[b])
        assert int(niter[b]) == int(n_one), b
        assert torch.equal(counts[b], one), b
