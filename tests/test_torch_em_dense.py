"""The port's dense one-hot EM (`ops/em_dense.py`) against the JAX
package's (`oarfish_tpu/ops/em_dense.py`) on the same seeded cells.

Cells are made with numpy (`tests/test_em_dense.py`'s generator) and
packed once for each package, f64 on the CPU. One m-step agrees to rtol
1e-12 (the batched products add in another order than XLA's dots); whole
EMs at both thresholds of the JAX package's own test run the same
iterations per cell and agree to rtol 1e-9; SQUAREM reaches the same fixed
point as the plain EM (the JAX package's own bar); a bucket run in
sub-batches gives the written counts of one batch; and the copied
`coarsen_buckets` gives the same keys and cell lists as the JAX one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oarfish_tpu.ops import em_dense as jdense
from oarfish_tpu.quant import single_cell as jsc
from oarfish_tpu_torch.ops import em_dense as tdense
from oarfish_tpu_torch.quant import single_cell as tsc
from util_torch import one_torch_thread  # noqa: F401 (autouse fixture)

T_GLOBAL = 64


def make_cells(rng, n_cells, t_global=T_GLOBAL):
    """`tests/test_em_dense.py::make_cells`."""
    cells = []
    for _ in range(n_cells):
        r_c = int(rng.integers(3, 40))
        sizes = rng.geometric(0.5, size=r_c).clip(1, 8)
        a_c = int(sizes.sum())
        txp = rng.integers(0, t_global, size=a_c).astype(np.int32)
        w = np.exp(rng.normal(0, 0.5, size=a_c))
        rid = np.repeat(np.arange(r_c, dtype=np.int32), sizes)
        cells.append((txp, w, rid, r_c))
    return cells


def pack_both(cells):
    """One bucket packed by both packages, and its uniform init."""
    a_p = tsc._ceil_pow2(max(len(c[0]) for c in cells))
    r_p = tsc._ceil_pow2(max(c[3] for c in cells))
    t_p = tsc._ceil_pow2(max(int(c[0].max()) + 1 for c in cells))
    parts = ([c[0] for c in cells], [c[1] for c in cells],
             [c[2] for c in cells], a_p, r_p, t_p)
    jd = jdense.DenseCellEm.build(*parts, dtype=jnp.float64)
    td = tdense.DenseCellEm.build(*parts, dtype=torch.float64, device="cpu")
    init = np.stack([np.full(t_p, c[3] / T_GLOBAL) for c in cells])
    return jd, td, init


def test_build_packs_like_the_jax_package():
    jd, td, _ = pack_both(make_cells(np.random.default_rng(1), 6))
    for f in ("txp", "rid", "weights"):
        np.testing.assert_array_equal(getattr(td, f).numpy(),
                                      np.asarray(getattr(jd, f)))
    assert td.txp.dtype == torch.int16 and (td.t_pad, td.r_pad) == (
        jd.t_pad, jd.r_pad)
    sr_t, sr_j = td.densify(), jd.densify()
    np.testing.assert_array_equal(sr_t.S.numpy(), np.asarray(sr_j.S, np.float64))
    np.testing.assert_array_equal(sr_t.R.numpy(), np.asarray(sr_j.R, np.float64))


def test_m_step_dense_matches_jax():
    jd, td, init = pack_both(make_cells(np.random.default_rng(3), 7))
    want = np.asarray(jdense._m_step_dense(jd, jnp.asarray(init)))
    got = tdense._m_step_dense(td.densify(), torch.from_numpy(init)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("thresh", [1e-3, 5e-2])
def test_run_em_dense_matches_jax(thresh):
    jd, td, init = pack_both(make_cells(np.random.default_rng(11), 9))
    want, niter_j = jdense.run_em_dense(jd, jnp.asarray(init), 400, thresh)
    got, niter_t = tdense.run_em_dense(td, torch.from_numpy(init), 400,
                                       thresh)
    np.testing.assert_array_equal(niter_t.numpy(), np.asarray(niter_j))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                               atol=1e-9)
    if thresh < 1e-2:
        # per-cell freezing really happened (iteration counts differ)
        assert len(set(niter_t.tolist())) > 1


def test_run_em_dense_squarem_same_fixed_point():
    """`tests/test_em_dense.py`'s bar for SQUAREM against the plain EM,
    and the port's accelerated run against the JAX one to the same bar."""
    jd, td, init = pack_both(make_cells(np.random.default_rng(5), 5))
    plain, _ = tdense.run_em_dense(td, torch.from_numpy(init), 1000, 1e-8)
    acc, _ = tdense.run_em_dense_squarem(td, torch.from_numpy(init), 1000,
                                         1e-8)
    jacc, _ = jdense.run_em_dense_squarem(jd, jnp.asarray(init), 1000, 1e-8)
    plain, acc = plain.numpy(), acc.numpy()
    for other in (acc, np.asarray(jacc)):
        np.testing.assert_allclose(plain, other, atol=0.25)
        np.testing.assert_allclose(plain.sum(axis=1), other.sum(axis=1),
                                   rtol=1e-6)


@pytest.mark.parametrize("accel", [False, True])
def test_sub_batches_equal_one_batch(accel):
    """A bucket run as sub-batches of 1, 2 and 4 cells (the last shorter)
    gives the counts of one batch, as the writer writes them (f32), and
    the same iterations: sub-batching only regroups independent cells (the
    JAX package's bar, `tests/test_em_dense.py`). The f64 values may differ
    in their last bits: torch's CPU kernels pick their order of addition by
    the number of cells (`bmm` of a single matrix, SQUAREM's row sums)."""
    _, td, init = pack_both(make_cells(np.random.default_rng(7), 9))
    init = torch.from_numpy(init)
    one, n1 = tdense.run_em_dense_scan(td, init, 9, 300, 1e-3, accel=accel)
    assert one.shape == (9, td.t_pad)
    for sub in (1, 2, 4):
        got, n = tdense.run_em_dense_scan(td, init, sub, 300, 1e-3,
                                          accel=accel)
        assert torch.equal(n, n1), sub
        assert torch.equal(got.float(), one.float()), sub


@pytest.mark.parametrize("max_buckets", [2, 4, 12])
def test_coarsen_buckets_matches_jax(max_buckets):
    """The copied `coarsen_buckets` merges the same buckets, into the same
    keys, with the cells in the same order."""
    cells = make_cells(np.random.default_rng(2), 120)

    def buckets(mod):
        out = {}
        for i, (txp, w, rid, r_c) in enumerate(cells):
            key = (mod._ceil_pow2(len(txp)), mod._ceil_pow2(r_c),
                   mod._ceil_pow2(int(txp.max()) + 1))
            b = out.get(key)
            if b is None:
                b = out[key] = mod.CellBatch(*key, T_GLOBAL)
            b.add(i, txp, w, rid, r_c, np.unique(txp))
        return mod.coarsen_buckets(out, max_buckets=max_buckets)

    got, want = buckets(tsc), buckets(jsc)
    assert sorted(got) == sorted(want)
    assert len(got) <= max_buckets
    for key in want:
        assert got[key].cell_index == want[key].cell_index, key
        assert got[key].num_reads == want[key].num_reads, key
