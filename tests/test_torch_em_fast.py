"""Scatter-free EM of the torch port vs the JAX package.

Both packages get the same layouts (their `build` functions must agree
array for array, and `convert.py` carries the JAX layouts across) and the
same arithmetic, but not the same order of additions: the tile prefix is
`associative_scan` in JAX and a doubling scan / f64 cumsum here, and the
row sums and cumsums of the two frameworks add in different orders. So
EM results are held to tolerance: f64 rtol 1e-9, f32 L1/R < 2e-3 (the JAX
package's own f32 bound in `tests/test_em_fast.py`).

With the gather plan on, the JAX kernel rounds an f64 table to f32 while
the port's passes f64 through; that case is therefore compared with the
JAX run *without* the plan at 1e-9 and with the JAX run *with* the plan
at the JAX package's own tolerance for it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oarfish_tpu.ops import em_fast as jfast
from oarfish_tpu.ops.em_oracle import do_em_oracle
from oarfish_tpu_torch.ops import em as tem
from oarfish_tpu_torch.ops import em_fast as tfast
from oarfish_tpu_torch.ops.convert import fast_em_data_from_numpy
from oarfish_tpu_torch.utils import trace
from test_torch_em import random_csr
from util_torch import one_torch_thread  # noqa: F401 (autouse fixture)

F64 = torch.float64
SHAPES = [(0, 300, 40, 8), (1, 1500, 200, 30), (2, 50, 10, 3)]
ARRAY_FIELDS = ("txp_csc", "w_csc", "read_csc", "txp_offsets", "off_tile",
                "off_prev", "off_inner")
META_FIELDS = ("bucket_rows", "num_reads", "num_txps", "num_tiles", "g_rows",
               "g_table_rows", "use_pallas_gather")


def build_both(seed, R, T, max_k, f64=True, gather=False):
    rng = np.random.default_rng(seed)
    txp_id, w, boundaries, read_id, R, T = random_csr(rng, R, T, max_k)
    jd, jorder = jfast.FastEmData.build(
        txp_id, w, boundaries, T,
        dtype=jnp.float64 if f64 else jnp.float32, use_pallas_gather=gather)
    td, torder = tfast.FastEmData.build(
        txp_id, w, boundaries, T,
        dtype=F64 if f64 else torch.float32, use_pallas_gather=gather,
        device="cpu")
    np.testing.assert_array_equal(jorder, torder)
    return rng, (txp_id, w, boundaries, read_id), jd, td, torder


def from_jax(jd, dtype):
    """The JAX layout carried across by convert.py."""
    def npy(x):
        return None if x is None else np.asarray(x)

    return fast_em_data_from_numpy(
        [npy(t) for t in jd.bucket_txp], [npy(w) for w in jd.bucket_w],
        npy(jd.txp_csc), npy(jd.w_csc), npy(jd.read_csc),
        npy(jd.txp_offsets), npy(jd.g_p0), npy(jd.g_lane), npy(jd.g_hi),
        jd.bucket_rows, jd.num_reads, jd.num_txps, jd.num_tiles, jd.g_rows,
        jd.g_table_rows, jd.use_pallas_gather, dtype, "cpu",
    )


def assert_same_layout(a, b):
    for f in META_FIELDS:
        assert getattr(a, f) == getattr(b, f), f
    for f in ARRAY_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert getattr(a, f).dtype == getattr(b, f).dtype, f
    for f in ("bucket_txp", "bucket_w"):
        for x, y in zip(getattr(a, f), getattr(b, f), strict=True):
            assert torch.equal(x, y) and x.dtype == y.dtype, f
    for f in ("g_p0", "g_code"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert torch.equal(x, y) and x.dtype == y.dtype, f


@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("seed,R,T,max_k", SHAPES + [(11, 4000, 600, 5)])
def test_build_equals_jax_via_convert(seed, R, T, max_k, gather):
    _, _, jd, td, _ = build_both(seed, R, T, max_k, gather=gather)
    assert td.use_pallas_gather == jd.use_pallas_gather
    assert_same_layout(from_jax(jd, F64), td)


def test_gather_plan_turned_off_when_too_sparse(caplog):
    # 3 alignments over 10^5 transcripts: the row-split plan would be
    # far larger than 4A + TILE, so on the CPU (where the plan feeds the
    # plain version only) both packages turn it off
    txp_id = np.array([5, 50_000, 99_999], dtype=np.int32)
    w = np.ones(3)
    boundaries = np.array([0, 1, 2, 3], dtype=np.int64)
    with caplog.at_level("WARNING", logger="oarfish_tpu_torch"):
        # CHUNK_ROWS pads the plan to 256 rows = 32768 elements > 4*3+512
        td, _ = tfast.FastEmData.build(
            txp_id, w, boundaries, 100_000, dtype=F64, use_pallas_gather=True,
            device="cpu")
    jd, _ = jfast.FastEmData.build(
        txp_id, w, boundaries, 100_000, dtype=jnp.float64,
        use_pallas_gather=True)
    assert not td.use_pallas_gather and not jd.use_pallas_gather
    assert td.g_p0 is None
    assert any("sorted-gather plan" in r.message for r in caplog.records)
    assert_same_layout(from_jax(jd, F64), td)


@pytest.mark.parametrize("squarem", [False, True])
@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("seed,R,T,max_k", SHAPES)
def test_run_em_fast_matches_jax_f64(seed, R, T, max_k, gather, squarem):
    _, (txp_id, w, boundaries, _), jd, td, _ = build_both(seed, R, T, max_k)
    if gather:
        td, _ = tfast.FastEmData.build(
            txp_id, w, boundaries, T, dtype=F64, use_pallas_gather=True,
            device="cpu")
        # below ~8000 alignments the 256-row padding of the plan exceeds
        # 4A + TILE and both packages turn it off
        assert td.use_pallas_gather == (R >= 1500)
    jrun = jfast.run_em_fast_squarem if squarem else jfast.run_em_fast
    trun = tfast.run_em_fast_squarem if squarem else tfast.run_em_fast
    cj, nj = jrun(jd, jnp.full(T, R / T, jnp.float64), 200, 1e-3)
    ct, nt = trun(td, tem.uniform_init(td, F64), 200, 1e-3)
    assert int(nt) == int(nj)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-9, atol=1e-9)
    if not squarem:
        want = do_em_oracle(txp_id, w, boundaries, T, max_iter=200)
        np.testing.assert_allclose(ct.numpy(), want, rtol=1e-9, atol=1e-9)


def test_run_em_fast_gather_plan_vs_jax_gather_plan():
    """Both with the plan on, the case of `tests/test_em_fast.py`: the
    JAX kernel's f32 output bounds the agreement (atol 5e-4*R/T, rtol
    5e-3 there); the port itself matches the oracle to 1e-9."""
    R, T = 4000, 600
    _, (txp_id, w, boundaries, _), jd, td, _ = build_both(
        11, R, T, 5, gather=True)
    assert jd.use_pallas_gather and td.use_pallas_gather
    cj, nj = jfast.run_em_fast(jd, jnp.full(T, R / T, jnp.float64), 300, 5e-3)
    ct, nt = tfast.run_em_fast(td, tem.uniform_init(td, F64), 300, 5e-3)
    np.testing.assert_allclose(
        ct.numpy(), np.asarray(cj), atol=5e-4 * R / T, rtol=5e-3)
    want = do_em_oracle(txp_id, w, boundaries, T, max_iter=300,
                        convergence_thresh=5e-3)
    np.testing.assert_allclose(ct.numpy(), want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("gather", [False, True])
def test_run_em_fast_f32_close_to_jax_and_oracle(gather):
    # many reads: the tile prefix must hold mass to f32 level
    R, T = 6000, 300
    _, (txp_id, w, boundaries, _), jd, td, _ = build_both(
        3, R, T, 6, f64=False, gather=gather)
    assert td.use_pallas_gather == gather
    cj, _ = jfast.run_em_fast(jd, jnp.full(T, R / T, jnp.float32), 120, 1e-3)
    ct, _ = tfast.run_em_fast(td, tem.uniform_init(td, torch.float32), 120, 1e-3)
    assert ct.dtype == torch.float32
    ct = ct.double().numpy()
    want = do_em_oracle(txp_id, w, boundaries, T, max_iter=120)
    assert abs(ct.sum() - want.sum()) / want.sum() < 1e-5
    assert np.abs(ct - want).sum() / R < 2e-3
    assert np.abs(ct - np.asarray(cj, dtype=np.float64)).sum() / R < 2e-3


@pytest.mark.parametrize("squarem", [False, True])
@pytest.mark.parametrize("gather", [False, True])
def test_run_em_fast_multiplicity_matches_jax(gather, squarem):
    R, T = 1500, 200
    rng, (txp_id, w, boundaries, read_id), jd, td, order = build_both(
        1, R, T, 30)
    if gather:
        td, _ = tfast.FastEmData.build(
            txp_id, w, boundaries, T, dtype=F64, use_pallas_gather=True,
            device="cpu")
    mult = rng.multinomial(R, np.full(R, 1 / R)).astype(np.float64)[order]
    jrun = jfast.run_em_fast_squarem if squarem else jfast.run_em_fast
    trun = tfast.run_em_fast_squarem if squarem else tfast.run_em_fast
    cj, nj = jrun(jd, jnp.full(T, R / T, jnp.float64), 100, 1e-3,
                  multiplicity=jnp.asarray(mult))
    ct, nt = trun(td, tem.uniform_init(td, F64), 100, 1e-3,
                  multiplicity=torch.from_numpy(mult))
    assert int(nt) == int(nj)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-9, atol=1e-9)
    # and the segment-sum EM of the port on the original read order
    ed = tem.EmData.build(txp_id, w, read_id, R, T, dtype=F64,
                          device="cpu")
    inv = np.empty(R, dtype=np.int64)
    inv[order] = np.arange(R)
    run_seg = tem.run_em_squarem if squarem else tem.run_em
    cs, _ = run_seg(ed, tem.uniform_init(ed, F64), 100, 1e-3,
                    multiplicity=torch.from_numpy(mult[inv]))
    np.testing.assert_allclose(ct.numpy(), cs.numpy(), rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("gather", [False, True])
def test_batched_replicates_match_jax_vmap(gather):
    R, T = 1500, 200
    rng, (txp_id, w, boundaries, _), jd, td, _ = build_both(1, R, T, 30)
    if gather:
        td, _ = tfast.FastEmData.build(
            txp_id, w, boundaries, T, dtype=F64, use_pallas_gather=True,
            device="cpu")
    mult = rng.multinomial(R, np.full(R, 1 / R), size=5).astype(np.float64)
    init_j = jnp.full(T, R / T, jnp.float64)
    cj, nj = jax.vmap(
        lambda m: jfast.run_em_fast(jd, init_j, 400, 1e-4, multiplicity=m)
    )(jnp.asarray(mult))
    ct, nt = tfast.run_em_fast(
        td, tem.uniform_init(td, F64).expand(5, -1), 400, 1e-4,
        multiplicity=torch.from_numpy(mult))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert len(set(nt.tolist())) > 1
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-9, atol=1e-9)
    # a batch is its replicates side by side
    for b in range(5):
        one, n1 = tfast.run_em_fast(
            td, tem.uniform_init(td, F64), 400, 1e-4,
            multiplicity=torch.from_numpy(mult[b]))
        assert int(n1) == int(nt[b])
        np.testing.assert_allclose(
            one.numpy(), ct[b].numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("n", [1, 2, 7, 64, 1000])
def test_exclusive_tile_prefix(dtype, n):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.random((3, n)) * 1e4).to(dtype)
    hi, lo = tfast.exclusive_tile_prefix(x)
    assert hi.shape == lo.shape == (3, n + 1)
    assert hi.dtype == lo.dtype == dtype
    want = np.concatenate(
        [np.zeros((3, 1)), np.cumsum(x.double().numpy(), axis=1)], axis=1)
    got = hi.double().numpy() + lo.double().numpy()
    # the pair carries (nearly) twice the working precision
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)
    jhi, jlo = jfast.exclusive_tile_prefix(jnp.asarray(x[0].numpy()))
    np.testing.assert_allclose(
        got[0], np.asarray(jhi, np.float64) + np.asarray(jlo, np.float64),
        rtol=1e-13 if dtype == F64 else 1e-11, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_pallas_impl_on_card_matches_plain_indexing(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from oarfish_tpu_torch.ops import sorted_gather as tg

    rng = np.random.default_rng(0)
    txp_id, w, boundaries, _, R, T = random_csr(rng, 20000, 500, 6)
    with_k, _ = tfast.FastEmData.build(
        txp_id, w, boundaries, T, dtype=dtype, use_pallas_gather=True,
        device="cuda")
    without, _ = tfast.FastEmData.build(
        txp_id, w, boundaries, T, dtype=dtype, device="cuda")
    before = trace.counter("launch.sorted_gather")
    a, na = tfast.run_em_fast(with_k, tem.uniform_init(with_k, dtype), 100, 1e-3)
    assert trace.counter("launch.sorted_gather") == before + int(na) + 1
    a2, _ = tfast.run_em_fast(with_k, tem.uniform_init(with_k, dtype), 100, 1e-3)
    assert torch.equal(a, a2)  # bit-reproducible
    b, nb = tfast.run_em_fast(without, tem.uniform_init(without, dtype), 100, 1e-3)
    assert int(na) == int(nb)
    assert float((a - b).abs().sum()) / R < 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_sparse_input_on_card_keeps_the_plan_and_launches_the_kernel(dtype):
    """On the card `use_pallas_gather` is never turned off, however small
    or sparse the input: 3 alignments over 10^5 transcripts, and a small
    CSR whose plan is mostly padding, still launch the kernel once per
    m-step and agree with torch indexing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(2)
    tiny = (np.array([5, 50_000, 99_999], dtype=np.int32), np.ones(3),
            np.array([0, 1, 2, 3], dtype=np.int64), 100_000)
    txp_id, w, boundaries, _, R, T = random_csr(rng, 300, 40_000, 4)
    for txp_id, w, boundaries, T in (tiny, (txp_id, w, boundaries, T)):
        A, R = len(txp_id), len(boundaries) - 1
        with_k, _ = tfast.FastEmData.build(
            txp_id, w, boundaries, T, dtype=dtype, use_pallas_gather=True)
        assert with_k.device.type == "cuda"  # the default device
        assert with_k.use_pallas_gather and with_k.g_p0 is not None
        assert with_k.g_rows * 128 > 4 * A + tfast.TILE  # the CPU rule's case
        without, _ = tfast.FastEmData.build(
            txp_id, w, boundaries, T, dtype=dtype, device="cuda")
        before = trace.counter("launch.sorted_gather")
        a, na = tfast.run_em_fast(
            with_k, tem.uniform_init(with_k, dtype), 100, 1e-3)
        assert trace.counter("launch.sorted_gather") == before + int(na) + 1
        b, nb = tfast.run_em_fast(
            without, tem.uniform_init(without, dtype), 100, 1e-3)
        assert int(na) == int(nb)
        assert float((a - b).abs().sum()) / R < 2e-3
        assert float(a.sum()) == pytest.approx(R, rel=1e-5)
